"""CPU backward through the port's convs outside ``train_step`` (ROADMAP
C12): PyTorch 2.13's oneDNN backward of a strided conv over a channels-last
view of an NHWC tensor (g_a's first skip conv, 1x1 stride 2 over 3
channels) corrupts the heap, and the process aborts a few backwards later.
The port's convs hand the library a contiguous NCHW input wherever autograd
records a CPU conv, so these loops must run to their end.

Each case runs in a fresh interpreter: a crash fails the case (its exit
code and the end of its output in the message) and leaves the test worker
alive. The shapes are the smallest that aborted before the repair.
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import numpy as np
import torch
torch.set_num_threads(2)
"""

CASES = {
    # the conv alone: 20 forward/backward passes at [2, 64, 64, 3]
    "skip_conv": """
from flashgmm_tpu_torch.layers import Conv2d
conv = Conv2d(3, 192, 1, stride=2, generator=torch.Generator().manual_seed(0))
rs = np.random.RandomState(0)
for _ in range(20):
    x = torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32))
    x.requires_grad_(True)
    y = conv(x)
    assert y.shape == (2, 32, 32, 192)
    (y * y).mean().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(conv.weight.grad).all()
    conv.zero_grad(set_to_none=True)
print("done")
""",
    # the flagship's training forward and backward, outside train_step
    "flagship": """
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
model = Cheng2020AnchorCheckerboardGMMv2(N=32, device="cpu")
g = torch.Generator().manual_seed(0)
rs = np.random.RandomState(1)
for _ in range(10):
    x = torch.from_numpy(rs.rand(2, 128, 128, 3).astype(np.float32))
    out = model(x, training=True, generator=g)
    rate = sum(-torch.log2(v).sum() for v in out["likelihoods"].values())
    loss = rate / x[0, ..., 0].numel() + ((out["x_hat"] - x) ** 2).mean()
    loss.backward()
    assert torch.isfinite(loss)
    model.zero_grad(set_to_none=True)
print("done")
""",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_backward_runs_to_its_end(case):
    code = textwrap.dedent(_PRELUDE) + textwrap.dedent(CASES[case])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("done"), (
        f"exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
