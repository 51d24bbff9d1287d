"""Guards against environment knobs leaking into golden or benchmark runs
(port of vpt_tpu/envguard.py).

  * the module that reads a knob calls `guard_ablations()` at import: it
    raises if `VPT_REQUIRE_GOLDENS` is set (the goldens-are-mandatory mode)
    while a knob is off its default;
  * the bench module calls `require_clean_env()`, which refuses any `VPT_*`
    variable, so a benchmark always measures the default configuration.

The port reads one knob, `VPT_TRACE` (render/integrator.py).
"""

from __future__ import annotations

import os

# Knobs the port reads, with their defaults.
ABLATION_DEFAULTS = {
    "VPT_TRACE": "stream",  # the packet trace: the same results, not the main path
}


def poisoned_ablations() -> list[str]:
    """Names of the knobs set to a value other than their default."""
    return [name for name, default in ABLATION_DEFAULTS.items() if os.environ.get(name, default) != default]


def guard_ablations() -> None:
    """Raise if goldens are mandated while a knob is off its default."""
    if not os.environ.get("VPT_REQUIRE_GOLDENS"):
        return
    bad = poisoned_ablations()
    if bad:
        raise RuntimeError(
            f"VPT_REQUIRE_GOLDENS is set but these variables deviate from their defaults: {bad}. "
            "Unset them: golden runs must use the main trace path."
        )


def require_clean_env() -> None:
    """Refuse any VPT_* variable other than VPT_REQUIRE_GOLDENS."""
    bad = sorted(k for k in os.environ if k.startswith("VPT_") and k != "VPT_REQUIRE_GOLDENS")
    if bad:
        raise RuntimeError(
            f"benchmark refuses to run with VPT_* env vars set: {bad}. "
            "A benchmark measures the default configuration."
        )
