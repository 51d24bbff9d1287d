"""The port's counterparts of the JAX package's dispatch scripts:
`profile_dispatch` (scripts/profile_dispatch.py), `quick_bench`
(scripts/quick_bench.py) and `sweep_bench` (scripts/sweep_bench.py), and of
its Mosaic probes: `hopper_probe` (scripts/mosaic_probe.py and
scripts/smem_probe.py, their Pallas kernels as csrc/probe.cu), each run as
`python -m vpt_tpu_torch.tools.<name>` from the repository root."""
