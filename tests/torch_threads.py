"""Torch's intra-op threads under pytest-xdist.

Each worker process starts with as many intra-op threads as the machine has
cores, so ``-n 6`` on 8 cores runs ~48 busy-waiting threads: the torch
tests then run 4-100x slower than alone (``test_torch_trainer.py``: 26 s
alone, 325 s beside two other files; its 0.9 s handoff test 122 s in a
six-worker run), and the suite's length moves with its neighbours' load.
Every ``test_torch_*.py`` imports this module, and an xdist worker collects
them all before it runs a test, so each worker takes its share of the
cores. Without xdist nothing changes.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
