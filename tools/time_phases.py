"""Time some of ``chip_smoke.py``'s phases of the tree at ROOT, in one
process, on the card (default: 9, the serving features, and 16, the
compiled training programs; also 2, the kernels against their plain
versions with their times, 17, resilient training, 20, data and
sequence parallel training, 22, sharded serving with BERT and NMT under
tp, 24, the chaos sweep, and 27, queue A9.3's int8 models, control flow,
custom ops and estimator):

    python3 tools/time_phases.py ROOT [PHASE ...]

Prints ``TIMES ROOT phaseN S ... [card]``.  To compare two trees,
unpack one with ``git archive`` under ``build/`` (git-ignored) and run
them in turns in one call (parent, change, change, parent): each process
builds its tree's kernels first, outside the timed phases."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
phases = [int(p) for p in sys.argv[2:]] or [9, 16]
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.utils import native  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_line()
print("build", native.build(), flush=True)
dev = torch.device("cuda", 0)


def kernels():
    """Phase 2 as chip_smoke.py runs it: each prints its kernel, plain and
    library milliseconds."""
    timer = cs.Timer(torch, dev)
    cs.flash_cases(torch, dev, timer, card)
    cs.flash_bwd_cases(torch, dev, timer, card)
    cs.ring_mode_cases(torch, dev, timer, card)
    cs.cross_case(torch, dev, timer, card)
    cs.paged_cases(torch, dev, timer, card,
                   [len(p) for p in cs.make_prompts()])


run = {2: kernels,
       9: lambda: cs.features_path(torch, card, cs.make_prompts()),
       16: lambda: cs.training_programs_path(torch, card),
       17: lambda: cs.resilient_path(torch, card),
       20: lambda: cs.parallel_path(torch, card),
       22: lambda: cs.shard_path(torch, card),
       24: lambda: cs.chaos_path(torch, card),
       27: lambda: cs.a93_path(torch, card)}
times = []
for p in phases:
    t0 = time.monotonic()
    run[p]()
    times.append(f"phase{p} {time.monotonic() - t0:.1f}")
    cs.free(torch)
print(f"TIMES {root} {' '.join(times)} [{card}]", flush=True)
