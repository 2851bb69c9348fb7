"""Experiment harness: the paper's figures and timing sweep on the port
(reference: experiment_list.c + main.c:1948-2016)."""
