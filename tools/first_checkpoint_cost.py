"""Time a fresh process's ``import torch`` and its first
``torch.utils.checkpoint`` call, which imports ``torch._dynamo`` (the
function is wrapped by ``torch._disable_dynamo``), then a second call:

    python3 tools/first_checkpoint_cost.py

Every new process that runs a remat layer pays the first call once
(``models/transformer.py`` ``_remat_layer``, ``models/stacked.py``)."""
import time

t = time.time()
import torch  # noqa: E402
print("import torch", round(time.time() - t, 2), flush=True)
import torch.utils.checkpoint as ck  # noqa: E402
x = torch.ones(4, requires_grad=True)
t = time.time()
y = ck.checkpoint(lambda a: a * 2, x, use_reentrant=False)
print("first checkpoint call (imports torch._dynamo)",
      round(time.time() - t, 2), flush=True)
t = time.time()
y = ck.checkpoint(lambda a: a * 2, x, use_reentrant=False)
print("second call", round(time.time() - t, 4), flush=True)
