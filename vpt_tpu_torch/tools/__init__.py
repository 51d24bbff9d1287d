"""The port's counterparts of the JAX package's dispatch scripts:
`profile_dispatch` (scripts/profile_dispatch.py), `quick_bench`
(scripts/quick_bench.py) and `sweep_bench` (scripts/sweep_bench.py), each
run as `python -m vpt_tpu_torch.tools.<name>` from the repository root."""
