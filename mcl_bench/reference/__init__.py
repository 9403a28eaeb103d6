"""The plain reference the benchmark holds the program to.

Plain NumPy and PyTorch, written from the semantics of the MCL correction
(the upstream node's motion and beam models, the shear-scan range LUT's
definition, systematic resampling over a float32 CDF). It imports nothing
of the program and takes nothing the program derived: the map, the LUT
entries, the addresses, the draws and the actions are worked out again
here from the map files, the trace and the seeds.
"""
