"""Deterministic fault injection for the port, a copy of
``repro.resilience`` (numpy only): :mod:`repro_torch.resilience.chaos`
turns a spec such as ``"kill@3,nonfinite@5,stall@4:8"`` into a fault
schedule keyed on (seed, step or tick) that the Trainer and the serve
engine replay exactly. Recovery lives where the state lives: the
non-finite gate and rollback in ``train.trainer``, the checksummed
restore in ``ckpt.checkpoint``, deadlines and shedding in
``serve.engine``; every injection and recovery is counted on the obs
registry."""
from repro_torch.resilience.chaos import ChaosEngine, ChaosKill, Fault  # noqa: F401
