"""Command line: python -m sdflabel_tpu_torch.main <config.ini> MODE

Counterpart of sdflabel_tpu/main.py (reference main.py:20-60): parse the
INI, seed numpy, copy the config into ``[log] dir``, and run one mode:

  --refine    the KITTI driver (pipelines/refine_css.py::refine_css, all
              of a frame's crops refined at once), dumps and evaluation
  --evaluate  evaluate the dumps of ``[output] labels``, difficulties 0, 1
  --demo      refine the bundled demo frame (with ``[visualization]
              viz_type`` 2d or 3d, as the stock configs/config_demo.ini
              sets it, the trajectory PNGs and HTML scenes too)
  --train     train the CSS network (pipelines/train_css.py)

Every mode runs on the card; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from sdflabel_tpu_torch import config as cfg_mod


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", default="config.ini", help="config file")
    parser.add_argument("--train", "-trn", action="store_true",
                        help="train css network")
    parser.add_argument("--refine", "-ref", action="store_true",
                        help="pose/shape refinement")
    parser.add_argument("--evaluate", "-eval", action="store_true",
                        help="evaluate generated dumps")
    parser.add_argument("--demo", "-d", action="store_true",
                        help="demo refinement")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    np.random.seed(1)
    try:
        cfgp = cfg_mod.load_ini(args.config)
    except FileNotFoundError:
        print("Error: None of the config files could be read")
        sys.exit(1)

    log_dir = cfg_mod.read_cfg_string(cfgp, "log", "dir", default="log")
    os.makedirs(log_dir, exist_ok=True)
    shutil.copyfile(args.config, os.path.join(
        log_dir, os.path.basename(log_dir.rstrip("/")) + ".ini"))

    if args.train:
        from sdflabel_tpu_torch.pipelines.train_css import train_css

        train_css(cfgp, device=args.device)
    elif args.refine:
        from sdflabel_tpu_torch.pipelines.refine_css import refine_css

        refine_css(cfgp, device=args.device)
    elif args.evaluate:
        from sdflabel_tpu_torch.pipelines.evaluate_dump import evaluate

        evaluate(cfgp, device=args.device)
    elif args.demo:
        from sdflabel_tpu_torch.pipelines.refine_css import refine_css_demo

        refine_css_demo(cfgp, device=args.device)


if __name__ == "__main__":
    main()
