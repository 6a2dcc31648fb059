"""Hold torch's intra-op threads to this test process's share of the cores.

pytest-xdist runs the suite in several worker processes, and torch's default
of one intra-op thread a core in every one of them oversubscribes the machine
many times over (their OpenMP threads spin against each other). Every
`tests/test_torch_*.py` imports this module before its first torch op; a
test that starts processes of its own gives each `share(workers)`.
"""

import os

import torch


def share(processes: int = 1) -> int:
    """Cores for each of `processes` processes started by this worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // (workers * processes))


torch.set_num_threads(share())
