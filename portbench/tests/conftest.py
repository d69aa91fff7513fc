import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# one intra-op thread a process, as portbench/run.py sets for a run: test
# workers running side by side then do not oversubscribe the cores, and a
# small run's window holds as many calls under pytest-xdist as alone
torch.set_num_threads(1)
