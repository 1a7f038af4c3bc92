"""Training cells: `train.trainer.train` as `cli.train` calls it.

Set-up builds the bundle (harness/bundle.py, no decode settings: fp32
masters, bf16 compute) and a pool of seeded batches, then makes one call
to `trainer.train` with the configuration's optimizer, schedule,
SpecAugment and seed. The call's batch iterator is `Feed`: its first
`checked_steps` batches are set-up, and the state they leave is what the
check reads (the loss of each step, Adam's first moment after step 1,
the parameters after the last); then the window opens and the same call
trains on until `seconds` have passed on the host clock, when the feed
stops. The rate is all synchronised steps times the batch over the
window's whole time. A traced run closes the same window with a
synchronise, for the host-clock metrics, then trains on under the
profiler for the traffic's `trace_seconds`, for the device metrics. No
checkpoint is written: `ckpt_every` is 0.

The feed reads the trainer's state from the trainer's frame
(`sys._getframe`), the only place where the loop keeps it. Once the
window has closed and the program is freed, reference/train_check.py
runs the same first steps in float32 and compares.
"""

from __future__ import annotations

import contextlib
import sys
import time

from harness import bundle as hb
from harness import core, inputs
from harness.trace import DeviceTrace
from reference import train_check


class _Quiet:
    """A logger that keeps nothing: the trainer still reads its metrics
    every `log_every` steps."""

    def log(self, step, metrics, prefix=""):
        pass

    def close(self):
        pass


def _find(state, key):
    if isinstance(state, dict):
        if key in state:
            return state[key]
        for v in state.values():
            found = _find(v, key)
            if found is not None:
                return found
    return None


class Feed:
    """The trainer's batch iterator, which also opens and closes the
    window."""

    def __init__(self, run: core.Run, model, batches, checked: int,
                 seconds: float, device, t_start: float, trace: bool,
                 trace_seconds: float):
        self.run, self.model, self.batches = run, model, batches
        self.checked, self.seconds, self.device = checked, seconds, device
        self.t_start, self.trace = t_start, trace
        self.trace_seconds = trace_seconds
        self.k = 0
        self.losses, self.mu1, self.params = [], None, None
        self.tracer = None
        self.t0 = self.steps = self.t_trace = None
        self.last = None

    def __iter__(self):
        return self

    def __next__(self):
        import torch
        now_ns = time.time_ns()
        if self.last is not None:
            self.run.spans.append(core.Span("train_step", self.last, now_ns))
        k = self.k
        if 1 <= k <= self.checked:
            trainer = sys._getframe(1).f_locals
            self.losses.append(trainer["metrics"]["loss"].detach().clone())
            if k == 1:
                self.mu1 = {n: t.clone() for n, t in
                            _find(trainer["state"].opt_state, "mu").items()}
        if k == self.checked:
            self.params = {n: p.detach().clone()
                           for n, p in self.model.named_parameters()}
            core.sync(self.device)
            self.run.setup_s = time.perf_counter() - self.t_start
            if torch.device(self.device).type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.t0 = time.perf_counter()
        elif self.t_trace is not None:
            if time.perf_counter() - self.t_trace >= self.trace_seconds:
                raise StopIteration
        elif k > self.checked and time.perf_counter() - self.t0 >= self.seconds:
            self.steps = k - self.checked
            if not self.trace:
                raise StopIteration
            core.sync(self.device)
            self.run.window_s = time.perf_counter() - self.t0
            self.tracer = DeviceTrace().__enter__()
            self.t_trace = time.perf_counter()
        self.k += 1
        self.last = time.time_ns()
        return self.batches[k % len(self.batches)]

    def close(self):
        """Synchronise and close the window (or the traced steps) once the
        trainer has returned."""
        core.sync(self.device)
        if self.tracer is None:
            self.run.window_s = time.perf_counter() - self.t0
        else:
            self.tracer.__exit__(None, None, None)
            self.run.trace = self.tracer.summary(self.run.spans)


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control=None) -> core.Run:
    import torch
    from yourmt3_tpu_torch.train import trainer

    run = core.Run(cell, seed)
    traffic, config, tr = cell.traffic, cell.config, cell.config["train"]
    bundle = hb.build(config, device, seed)
    cfg = bundle.cfg
    batches = inputs.train_batches(
        seed, traffic, bundle.audio_cfg.input_frames, cfg.num_channels,
        cfg.max_target_length, cfg.vocab_size, bundle.audio_cfg.sample_rate)
    feed = Feed(run, bundle.model, batches, traffic["checked_steps"], seconds,
                device, t_start, trace, traffic["trace_seconds"])
    tmp = core.run_dir()
    with contextlib.suppress(StopIteration):
        trainer.train(bundle, feed, total_steps=tr["total_steps"],
                      log_every=tr["log_every"], ckpt_every=0, ckpt_dir=tmp,
                      optimizer=tr["optimizer"], base_lr=tr["base_lr"],
                      schedule=tr["schedule"], warmup_steps=tr["warmup_steps"],
                      spec_augment=tr["spec_augment"], seed=seed, logger=_Quiet())
    if feed.steps is None:
        raise RuntimeError("the trainer returned before the window closed")
    feed.close()
    cuda = torch.device(device).type == "cuda"
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.counts = {"steps": feed.steps, "segments": feed.steps * traffic["batch_size"],
                  "batch": traffic["batch_size"]}
    program = {"losses": [float(x) for x in feed.losses], "mu1": feed.mu1,
               "params": feed.params}
    del bundle, feed
    if cuda:
        torch.cuda.empty_cache()
    run.checks = train_check.check(config, seed, batches[: traffic["checked_steps"]],
                                   program, device, traffic, cell.limits, control,
                                   notes=run.notes)
    core.remove_dir(tmp)
    return run
