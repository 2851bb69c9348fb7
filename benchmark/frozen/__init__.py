"""A frozen copy of the port's plain writers and raw-file readers
(vulkan_renderer_tpu_torch at commit b4b0e8b): the scene, texture and
noise writers the benchmark makes its inputs with (tools/, assets/vks.py
and assets/vkt.py's encoders), and the readers of those raw files and of
the packaged LTC fits. The benchmark's yardstick must not move when the
program does, so these files are copies, not imports: nothing here
imports the port, JAX or the JAX package. The reference's shading is not
here: reference/ transcribes it from the JAX package. Departures from
the copied files: assets/ltc_table.py and assets/noise.py find the JAX
package's packaged data files (raw LTC fits, noise blobs) one directory
further up, since this tree sits one level deeper in the checkout.
"""
