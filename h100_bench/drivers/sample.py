"""Driver of the sampling mixes: batch after batch of samples with log q,
each one call of `ecnf_tpu_torch.cnf.sampling.sample_and_log_prob_cnf` (the
call ``sample --with-log-prob`` makes per batch), back to back from one
caller.  Traffic keys: ``batch``, ``step_size`` (fixed-step RK4),
``trace`` (``exact``: the structured tangent over the zero-CoM columns;
``fused``: the fused kernel over every column; ``hutchinson``: one Gaussian
probe per sample), ``traced_solves`` (the traced window's work) and
``compared_rows`` (rows of the window checked against the reference)."""
import math
import time
from typing import Optional

import numpy as np
import torch

import harness

STAGES = {"rk4": 4}  # field evaluations per step


class Run:
    def __init__(self, cell: dict, reference, seed: int, device: torch.device):
        from ecnf_tpu_torch.cnf import sampling

        self.sampling = sampling
        self.cfg, self.traffic, self.limits = cell["config"], cell["traffic"], cell["limits"]
        self.reference, self.seed, self.device = reference, seed, device
        c, tr = self.cfg, self.traffic
        self.cnf = harness.build_cnf(c, device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.weights = harness.make_weights(reference.param_shapes(c), self.generator, device)
        self.cnf.field.load_state_dict(self.weights)
        self.solve = sampling.SolveConfig(
            use_fixed_step_size=True, step_size=tr["step_size"], method=tr["method"],
            fused_trace=tr["trace"] == "fused",
        )
        self.features = torch.zeros((tr["batch"], c["n_nodes"]), dtype=torch.int64, device=device)
        self.outputs = []
        self._solve()  # warm-up: every shape of the window, the kernels' builds
        self.outputs = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve(self) -> int:
        """One batch: inputs drawn from the seed, the program's call, its
        outputs kept for the check.  Returns its field evaluations."""
        c, tr = self.cfg, self.traffic
        B, S = tr["batch"], c["n_nodes"] * c["dim"]
        noise = torch.randn((B, S), generator=self.generator, device=self.device)
        x0 = c["base_scale"] * harness.remove_mean(noise, c["n_nodes"], c["dim"])
        eps = None
        if tr["trace"] == "hutchinson":
            eps = torch.randn((B, S), generator=self.generator, device=self.device)
        x1, log_q, stats = self.sampling.sample_and_log_prob_cnf(
            self.cnf, B, self.features, approx=eps is not None, cfg=self.solve, x0=x0, eps=eps,
            return_stats=True,
        )
        self._sync()
        self.outputs.append((x0, eps, x1, log_q))
        return stats.num_attempts * STAGES[self.traffic["method"]]

    def window(self, seconds: float) -> dict:
        solves = evals = 0
        start = time.perf_counter()
        while True:
            evals += self._solve()
            solves += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        rows = solves * self.traffic["batch"]
        return dict(seconds=elapsed, solves=solves, field_evals=evals, rows=rows,
                    end_to_end={"samples_per_s": rows / elapsed})

    def traced_window(self) -> dict:
        n = self.traffic["traced_solves"]
        return dict(solves=n, field_evals=sum(self._solve() for _ in range(n)))

    @property
    def attempted(self) -> int:
        return len(self.outputs) * self.traffic["batch"]

    @property
    def failed(self) -> int:
        x1 = torch.cat([o[2] for o in self.outputs])
        lq = torch.cat([o[3] for o in self.outputs])
        return int((~(torch.isfinite(x1).all(1) & torch.isfinite(lq))).sum())

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.cnf = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compared_rows(self) -> dict:
        """A sample of the window's rows, drawn from the seed."""
        B = self.traffic["batch"]
        total = len(self.outputs) * B
        rng = np.random.default_rng(self.seed)
        picks = rng.choice(total, size=min(self.traffic["compared_rows"], total), replace=False)
        picks = sorted(int(p) for p in picks)
        take = lambda k: torch.stack([self.outputs[p // B][k][p % B] for p in picks])
        return dict(x0=take(0), eps=take(1) if self.outputs[0][1] is not None else None,
                    x1=take(2), log_q=take(3))

    def precision(self) -> str:
        """The precision of the route's products: the fused trace runs in f32
        whatever the compute dtype."""
        if self.traffic["trace"] == "fused" or self.cfg["compute_dtype"] != "bfloat16":
            return "f32"
        return "bf16"

    def references(self, precisions) -> dict:
        """The reference's ``(x1, log q)`` of the compared rows, from the same
        x0 and probes, in each of ``precisions``."""
        rows = self.compared_rows()
        n_steps = max(1, math.ceil(1.0 / self.traffic["step_size"] - 1e-12))
        features = torch.zeros((rows["x0"].shape[0], self.cfg["n_nodes"]), dtype=torch.int64,
                               device=self.device)
        return {p: self.reference.sample_and_log_q(
            self.weights, self.cfg, rows["x0"], features, n_steps, probes=rows["eps"],
            precision=p) for p in precisions}

    def yardsticks(self) -> list:
        """The reference's precisions that the gaps are measured with."""
        return ["f32"] if self.precision() == "f32" else ["f32", "bf16", "bf16_fp8_tangent"]

    def gaps(self, program, refs: dict) -> dict:
        """The numbers compared, from the program's ``(x1, log q)`` of the
        compared rows and the reference's (`references`).

        An f32 route: the largest gap to the f32 reference in x1 and in log q.

        A bf16 route: the gap to the reference computed in bf16 as the
        configuration states, root mean square over the rows, in units that
        follow each seed's sensitivity to rounding.  x1 (each row's gap the
        Euclidean norm): in units of the bf16 reference's gap to the f32 one.
        log q: in units of the gap that the tangent's products in fp8 open
        (``bf16_fp8_tangent``, x1 unchanged), so a trace one precision below
        the configuration's reads about 1.  Both sides round the same bf16
        weights, whose rounding moves the answers most; a gap to the f32
        reference would carry it on both sides and hide what is the
        program's own."""
        if self.precision() == "f32":
            x1, log_q = refs["f32"]
            return {"x1_gap": float((program[0] - x1).abs().max()),
                    "log_q_gap": float((program[1] - log_q).abs().max())}
        rms = lambda g: float(g.pow(2).mean().sqrt())
        (x1_f, _), (x1_b, log_q_b) = refs["f32"], refs["bf16"]
        log_q_t = refs["bf16_fp8_tangent"][1]
        return {"x1_vs_bf16": rms((program[0] - x1_b).norm(dim=1)) / rms((x1_b - x1_f).norm(dim=1)),
                "log_q_vs_bf16": rms(program[1] - log_q_b) / rms(log_q_t - log_q_b)}

    def check(self, control: Optional[str] = None) -> dict:
        """The compared rows against the reference run from the same x0 and
        probes (`gaps`).  ``control`` puts the reference computed in that
        precision in the program's place."""
        rows = self.compared_rows()
        precisions = self.yardsticks() + ([control] if control else [])
        refs = self.references(list(dict.fromkeys(precisions)))
        program = refs[control] if control else (rows["x1"], rows["log_q"])
        return {k: {"value": v, "limit": self.limits[k]} for k, v in self.gaps(program, refs).items()}
