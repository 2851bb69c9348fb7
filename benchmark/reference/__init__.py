"""The plain reference: reference/render.py renders chosen pixels of a
frame in plain PyTorch from the inputs the benchmark hands the program,
and decides `correct`."""
