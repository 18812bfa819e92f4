"""Fault-tolerant training driver — the twin of
``repro/runtime/driver.py``: auto-resume from the newest committed
checkpoint, periodic saves, a straggler watchdog and a fault hook for
tests. Everything a restart needs lives in the checkpoint: parameters,
optimizer moments, the step and so the data cursor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.runtime.straggler import StepTimer, StragglerWatchdog


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    straggler_factor: float = 3.0


class TrainDriver:
    def __init__(self, *, train_step: Callable, state, data, ckpt_dir: str,
                 cfg: DriverConfig,
                 fault_hook: Callable[[int], None] | None = None):
        self.train_step = train_step
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints,
                                      async_save=cfg.async_checkpoint)
        self.watchdog = StragglerWatchdog(factor=cfg.straggler_factor)
        self.fault_hook = fault_hook
        self.metrics_log: list[dict] = []

        # auto-resume: the newest committed checkpoint wins
        restored, extra = self.ckpt.restore(state)
        if restored is not None:
            self.state = restored
            self.start_step = int(extra["step"])
            print(f"[driver] resumed from step {self.start_step}")
        else:
            self.state = state
            self.start_step = 0

    def run(self):
        cfg = self.cfg
        step = self.start_step
        while step < cfg.total_steps:
            if self.fault_hook is not None:
                self.fault_hook(step)      # tests: raise to simulate a crash
            batch = self.data.batch(step)
            with StepTimer() as t:
                self.state, metrics = self.train_step(self.state, batch)
                # the device->host read ends the step on the device
                m = {k: float(v) for k, v in metrics.items()}
            step += 1
            if self.watchdog.record(step, t.dt):
                print(f"[driver] STRAGGLER step {step}: {t.dt:.3f}s "
                      f"(deadline {self.watchdog.deadline:.3f}s)")
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                m["step_time_s"] = t.dt
                m["step"] = step
                self.metrics_log.append(m)
                print(f"[driver] step {step}: loss {m['loss']:.4f} "
                      f"({t.dt * 1e3:.0f} ms)")
            if step % cfg.ckpt_every == 0:
                self.ckpt.save(step, self.state, {"data_cursor": step})
        self.ckpt.save(cfg.total_steps, self.state,
                       {"data_cursor": cfg.total_steps}, block=True)
        self.ckpt.wait()
        return self.state, self.metrics_log
