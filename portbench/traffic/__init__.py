"""Traffic kinds: one module a kind, each a ``Driver`` that ``run.py``
builds from a configuration and a workload file.

A Driver makes its inputs from the seed in ``__init__``, runs every shape
of its cell once in ``warm_up``, runs one timed call in ``call(i)`` (the
i-th of the window; it need not synchronise), drops the program's state
in ``release`` and returns the compared numbers in ``check`` as
{name: value}, whose limits the workload file holds. ``min_calls`` is the
fewest calls a window needs for its check.
"""

from __future__ import annotations


def sim_config(config: dict, n: int, steps: int, control: bool):
    """The port's SimConfig for a configuration file: its physics and its
    backend, or the control's backend where the control is the port on a
    lower-precision path."""
    from mini_nbody_tpu_torch import SimConfig

    backend = config["backend"]
    if control:
        backend = config["control"]["backend"]
    return SimConfig(n=n, steps=steps, dt=config["dt"],
                     softening=config["softening"],
                     integrator=config["integrator"], backend=backend,
                     use_masses=bool(config["masses"]))


def reference_control(config: dict):
    """The reference's pair settings when the control is the reference at
    the precision below the configuration's, else None: pair weights
    rounded to ``mantissa_bits``, pair matrices in ``pair_dtype`` (float32
    unless the control names another), the state in float32."""
    ctl = config["control"]
    if ctl["kind"] != "reference":
        return None
    import torch

    from portbench.reference.integrate import Pairs

    return Pairs(getattr(torch, ctl.get("pair_dtype", "float32")),
                 ctl["mantissa_bits"])
