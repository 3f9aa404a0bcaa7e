"""Driver of the training mixes: flow-matching steps back to back, each one
call of the ``update`` that `ecnf_tpu_torch.training.state.make_update_fn`
builds (the call `training/setup.py: epoch` makes per minibatch), on data,
base samples and times drawn from the seed.  Traffic keys: ``batch``,
``microbatch``, ``data_scale`` (the spread of the stand-in data),
``checked_steps`` (the first steps, which set-up drives through the same
call and feed), ``checked_window_steps`` (the first steps of the timed
window; the reference follows both stretches) and ``traced_steps``."""
import statistics
import time
from typing import Optional

import torch

import harness


def _norms(tensors) -> list:
    return [float(x) for x in torch.stack([t.float().norm() for t in tensors]).cpu()]


def _copy(tensors: dict) -> dict:
    return {n: t.clone() for n, t in tensors.items()}


class Run:
    def __init__(self, cell: dict, reference, seed: int, device: torch.device):
        from ecnf_tpu_torch.training import optim, state

        self.cfg, self.traffic, self.limits = cell["config"], cell["traffic"], cell["limits"]
        self.reference, self.device = reference, device
        c, tr = self.cfg, self.traffic
        cnf = harness.build_cnf(c, device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.weights = harness.make_weights(reference.param_shapes(c), self.generator, device)
        cnf.field.load_state_dict(self.weights)
        optimizer = optim.build_optimizer(
            c["init_lr"], use_schedule=True, peak_lr=c["peak_lr"], end_lr=c["end_lr"],
            n_iter_warmup=c["n_iter_warmup"], n_iter_total=c["n_training_iter"],
        )
        self.update = state.make_update_fn(cnf, optimizer, use_ema=c["use_ema"],
                                           microbatch=tr["microbatch"])
        self.state = state.init_training_state(
            cnf, optimizer, torch.Generator(device=device).manual_seed(seed), use_ema=c["use_ema"]
        )
        self.features = torch.zeros((tr["batch"], c["n_nodes"]), dtype=torch.int64, device=device)
        self.losses = []
        # The first steps, through the window's own call and feed: set-up
        # and warm-up, and what the check compares.
        names = list(self.state.params)
        start = {n: p.clone() for n, p in self.state.params.items()}
        start_ema = {n: p.clone() for n, p in (self.state.ema_params or {}).items()}
        self.feeds = []
        for i in range(tr["checked_steps"]):
            feed = self._feed()
            self.feeds.append(feed)
            self._step(feed)
            if i == 0:  # Adam's first moment after one step is (1 - b1) g
                first_grad = _norms([m / 0.1 for m in self.state.opt_state.mu])
        self._sync()
        self.program = dict(
            names=names, loss=[float(l) for l in self.losses], grad=first_grad,
            change=_norms([self.state.params[n] - start[n] for n in names]),
            ema_change=_norms([self.state.ema_params[n] - start_ema[n] for n in names])
            if c["use_ema"] else None,
        )
        self.losses = []
        # Where the window's checked stretch starts, and (filled in by the
        # window) its feeds and where it ends.
        self.window_from = (_copy(self.state.params), _copy(self.state.ema_params or {}))
        self.window_feeds, self.window_to = [], None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _feed(self) -> dict:
        c, tr = self.cfg, self.traffic
        B, S = tr["batch"], c["n_nodes"] * c["dim"]
        x = torch.randn((B, S), generator=self.generator, device=self.device)
        noise = torch.randn((B, S), generator=self.generator, device=self.device)
        return dict(
            x=tr["data_scale"] * harness.remove_mean(x, c["n_nodes"], c["dim"]),
            x0=c["base_scale"] * harness.remove_mean(noise, c["n_nodes"], c["dim"]),
            t=torch.rand((B,), generator=self.generator, device=self.device),
            features=self.features,
        )

    def _step(self, feed: dict) -> None:
        self.state, info = self.update(self.state, feed["x"], feed["features"],
                                       x0=feed["x0"], t=feed["t"])
        self.losses.append(info["loss"])

    def window(self, seconds: float) -> dict:
        """Steps back to back for ``seconds`` (and at least the checked
        window steps).  After the checked steps it copies the parameters and
        their EMA, in the stream's order and without a synchronise."""
        cuda = self.device.type == "cuda"
        checked = self.traffic["checked_window_steps"]
        marks = []
        start = time.perf_counter()
        while True:
            feed = self._feed()
            if len(marks) < checked:
                self.window_feeds.append(feed)
            if cuda:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                self._step(feed)
                b.record()
                marks.append((a, b))
            else:
                t = time.perf_counter()
                self._step(feed)
                marks.append(time.perf_counter() - t)
            if len(marks) == checked:
                self.window_to = (_copy(self.state.params), _copy(self.state.ema_params or {}))
            if time.perf_counter() - start >= seconds and len(marks) >= checked:
                break
        self._sync()
        elapsed = time.perf_counter() - start
        ms = [a.elapsed_time(b) for a, b in marks] if cuda else [1e3 * t for t in marks]
        p95 = statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else ms[0]
        return dict(seconds=elapsed, steps=len(ms),
                    end_to_end={"train_steps_per_s": len(ms) / elapsed, "step_ms_p95": p95})

    def traced_window(self) -> dict:
        n = self.traffic["traced_steps"]
        for _ in range(n):
            self._step(self._feed())
        return dict(steps=n)

    @property
    def attempted(self) -> int:
        return len(self.losses) + len(self.feeds)

    @property
    def failed(self) -> int:
        losses = torch.stack(self.losses) if self.losses else torch.zeros(0)
        first = torch.tensor(self.program["loss"])
        return int((~torch.isfinite(losses)).sum()) + int((~torch.isfinite(first)).sum())

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.update = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_readings(self, steps: list, names: list) -> dict:
        k = self.traffic["checked_steps"]
        change = lambda key, a, b: _norms([a[key][n] - b[key][n] for n in names])
        start = {"params": self.weights, "ema": self.weights}
        out = dict(
            loss=[s["loss"] for s in steps], grad=_norms([steps[0]["grads"][n] for n in names]),
            change=change("params", steps[k - 1], start),
            window_change=change("params", steps[-1], steps[k - 1]),
        )
        if self.cfg["use_ema"]:
            out.update(ema_change=change("ema", steps[k - 1], start),
                       window_ema_change=change("ema", steps[-1], steps[k - 1]))
        return out

    def _program_readings(self) -> dict:
        names = self.program["names"]
        k = self.traffic["checked_window_steps"]
        (p0, e0), (p1, e1) = self.window_from, self.window_to
        out = dict(self.program, loss=self.program["loss"] + [float(l) for l in self.losses[:k]],
                   window_change=_norms([p1[n] - p0[n] for n in names]))
        if self.cfg["use_ema"]:
            out["window_ema_change"] = _norms([e1[n] - e0[n] for n in names])
        return out

    def check(self, control: Optional[str] = None, half_batch: bool = False) -> dict:
        """The reference follows the set-up's checked steps and then the
        window's first ones, from the same weights and feeds.  Compared:
        each step's loss (relative); the first gradient's norm; the norm of
        each parameter's change, and of its EMA's, over the set-up's steps
        and over the window's checked steps; each by the worst leaf, as the
        gap between the two norms over the larger of the reference's norm of
        that leaf and of the median leaf.  Leaves whose reference gradient
        is under a thousandth of the median leaf's (the last block's phi_h,
        which feeds nothing) are left out of the changes.

        ``control`` puts the reference computed in that precision in the
        program's place; ``half_batch`` puts there the reference on the first
        half of each batch (a step that leaves out half of the batch)."""
        names = self.program["names"]
        feeds = self.feeds + self.window_feeds
        steps = self.reference.train(self.weights, self.cfg, feeds)
        ref = self._reference_readings(steps, names)
        p = self._program_readings()
        if control is not None or half_batch:
            if half_batch:
                feeds = [{k: v[: len(v) // 2] for k, v in f.items()} for f in feeds]
            p = self._reference_readings(
                self.reference.train(self.weights, self.cfg, feeds, control or "f32"), names)
        median_grad = statistics.median(ref["grad"])
        moving = [i for i, g in enumerate(ref["grad"]) if g >= 1e-3 * median_grad]

        def worst(key, keep):
            prog, r = p[key], ref[key]
            med = statistics.median([r[i] for i in keep])
            return max(abs(prog[i] - r[i]) / max(r[i], med) for i in keep)

        checks = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(p["loss"], ref["loss"])),
            "grad_gap": worst("grad", range(len(names))),
        }
        keys = ["change", "window_change"]
        if self.cfg["use_ema"]:
            keys += ["ema_change", "window_ema_change"]
        checks.update({f"{key}_gap": worst(key, moving) for key in keys})
        return {k: {"value": float(v), "limit": self.limits[k]} for k, v in checks.items()}
