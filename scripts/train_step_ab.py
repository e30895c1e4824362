"""Phase 6's training step of two checkouts of the repo, in turns on one
card: the parent's and the change's kernels, the rest held equal.

    python3 scripts/train_step_ab.py PARENT_DIR CHANGE_DIR

In the order parent, change, change, parent, a fresh process in each
checkout runs that checkout's own chip_smoke.py phases 5 and 6
(``crops_phase``: 26 crops of 128x128 px; ``train_phase``: train_css for 4
steps of batch 13 at width 64 with the CE kernels, then 4 steps on one
fixed batch) and prints its steady ms/step (the median of steps 3 and 4)
and the fixed batch's step times. Each checkout builds its kernels at its
first run. Needs a card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r"""
import json, os, sys, tempfile
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
with tempfile.TemporaryDirectory() as out:
    crops_dir = cs.crops_phase(dev, out)[0]
    train = cs.train_phase(dev, crops_dir, os.path.join(out, "log"))[3]
print("RESULT " + json.dumps(train))
"""


def main() -> int:
    parent, change = (os.path.abspath(p) for p in sys.argv[1:3])
    rows = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        train = json.loads(line[len("RESULT "):])
        rows.append(dict(run=label, steady_ms=train["steady_ms_per_step"],
                         step_ms=train["step_ms"],
                         fixed_batch_step_ms=train["fixed_batch_step_ms"]))
        print(f"{label}: steady {train['steady_ms_per_step']:.3f} ms/step, "
              f"steps {[round(t, 3) for t in train['step_ms']]}, fixed "
              f"batch {[round(t, 3) for t in train['fixed_batch_step_ms']]}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
