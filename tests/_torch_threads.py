"""One intra-op thread for PyTorch in the port's CPU tests.

The suite runs under several pytest-xdist workers, each a process whose
PyTorch would start one OpenMP thread per core: the workers' threads then
contend for the cores, and small ops wait on each other's spinning
threads.  On an 8-core host running other work, a smoke-config train step
(demo-100m, B = 8, S = 64) took 1.7 s with 8 threads and 0.06 s with one.
Every port test module imports this module, so a worker uses one thread
whichever of them it runs; the processes a test starts set their own
(`_torch_dist` ranks, `tools/layout_sweep.py` children).  Elementwise
results do not depend on the thread count; tests that hold two port runs
bitwise run both in one process.
"""

import torch

torch.set_num_threads(1)
