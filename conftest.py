"""Thread budget for the PyTorch port's tests.

Each test process takes an equal share of the cores it may run on: under
xdist (``-n N``) the N workers would otherwise each start one torch thread
per core, N times the cores in all.  pytest loads this file before
``tests/conftest.py``, so the budget is set before torch does any work.
Processes the tests spawn themselves do not read this file and set their
own.
"""

import os

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(1)
