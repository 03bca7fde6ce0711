"""Time ``chip_smoke.py``'s phases 9 (the serving features) and 16 (the
compiled training programs) of the tree at ROOT, in one process, on the
card:

    python3 tools/time_phases.py ROOT

Prints ``TIMES ROOT phase9 S phase16 S [card]``.  To compare two trees,
unpack one with ``git archive`` under ``build/`` (git-ignored) and run
them in turns in one call (parent, change, change, parent): each process
builds its tree's kernels first, outside the timed phases."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.utils import native  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_line()
print("build", native.build(), flush=True)
t0 = time.monotonic()
cs.features_path(torch, card, cs.make_prompts())
t9 = time.monotonic() - t0
cs.free(torch)
t0 = time.monotonic()
cs.training_programs_path(torch, card)
t16 = time.monotonic() - t0
print(f"TIMES {root} phase9 {t9:.1f} phase16 {t16:.1f} [{card}]",
      flush=True)
