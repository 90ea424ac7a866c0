"""Fault-tolerant training loop: resume, preemption, stragglers, checkpoints.

The port of ``src/repro/train/loop.py``. The loop is restart-idempotent:
batch(step) is a pure function of the step, so a resume replays nothing;
checkpoints carry (params, opt, step) and are atomic; on entry the loop
restores the newest complete checkpoint of ``loop.ckpt_dir``. Parameters
are drawn from a ``torch.Generator`` on ``device`` seeded with
``loop.seed``. tests/test_torch_train.py kills the loop mid-run and holds
the resumed run's final parameters to an uninterrupted run's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim import adamw
from . import checkpoint as ckpt_lib
from . import fault
from .step import init_state, train_step

__all__ = ["LoopConfig", "run"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    n_micro: int = 1
    log_every: int = 10
    seed: int = 0


def run(cfg: ModelConfig, loop: LoopConfig, data_cfg: DataConfig,
        opt_cfg: Optional[adamw.AdamWConfig] = None,
        injector: Optional[fault.FailureInjector] = None,
        log: Callable[[str], None] = print, device="cuda") -> Dict[str, Any]:
    """Train on ``device``; returns {'state': final TrainState, 'losses': [...],
    'straggler_events': [...], 'last_step': int}. A step's time runs from
    its batch to its loss on the host, so it includes the device's work."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        state_dtype=cfg.opt_state_dtype, division=cfg.division)
    data = SyntheticLM(data_cfg)
    device = torch.device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(loop.seed))
    state = init_state(cfg, params, opt_cfg)

    start_step = 0
    if loop.ckpt_dir:
        restored_step, restored = ckpt_lib.restore_latest(loop.ckpt_dir, state)
        if restored_step is not None:
            state = restored
            start_step = restored_step
            log(f"[resume] restored checkpoint at step {restored_step}")

    watchdog = fault.StragglerWatchdog()
    losses = []
    last_step = start_step
    with fault.PreemptionGuard() as guard:
        for step in range(start_step, loop.total_steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
            if injector is not None:
                injector.check(step)
            state, metrics = train_step(cfg, opt_cfg, state, batch, n_micro=loop.n_micro)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ev = watchdog.observe(step, dt)
            if ev is not None:
                log(f"[straggler] step {ev.step}: {ev.duration:.3f}s "
                    f"(ewma {ev.ewma:.3f}s)")
            losses.append(loss)
            last_step = step + 1
            if step % loop.log_every == 0:
                log(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            should_ckpt = loop.ckpt_dir and (
                (step + 1) % loop.ckpt_every == 0 or guard.preempted
                or step + 1 == loop.total_steps)
            if should_ckpt:
                ckpt_lib.save(loop.ckpt_dir, step + 1, state, keep=loop.ckpt_keep)
            if guard.preempted:
                log(f"[preempt] checkpointed at step {step + 1}; exiting")
                break
    return {"state": state, "losses": losses,
            "straggler_events": watchdog.events, "last_step": last_step}
