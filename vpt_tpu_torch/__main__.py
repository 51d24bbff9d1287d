"""`python -m vpt_tpu_torch`: the command line (vpt_tpu_torch/cli.py)."""

from vpt_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
