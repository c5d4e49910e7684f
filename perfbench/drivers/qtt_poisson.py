"""The system under test for the QTT Poisson configurations: the port's
public solve entry on TT objects.

Mix arguments: ``entry`` "als_spd_fused" and its keyword ``args``
(``max_f32_sweeps``, ``df_sweeps``).  Each call solves from one starting
point of the pool, which the entry does not change; its result is the
solution TTTensor (float64 cores on the device).  The entry's f32
half-sweep count (the length of the history it returns) is counted as
``f32_half_sweeps``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.drivers import port


class System:
    def __init__(self, cfg: Dict, mix: Dict, inputs: Dict,
                 device: torch.device):
        import xerus_tpu_torch as xt
        if mix["entry"] != "als_spd_fused":
            raise ValueError(f"qtt_poisson has no entry {mix['entry']!r}")
        self.xt = xt
        tt = xt.convert.tt_from_numpy
        self.A = tt(inputs["A"], operator=True, device=device)
        self.b = tt(inputs["b"], device=device)
        # the generator's starting points are canonical at site 0
        self.x0 = [tt(port.host_cores(cores), canonicalized=True,
                      core_position=0, device=device)
                   for cores in inputs["x0"]]
        self.args = dict(mix.get("args", {}))
        self.f32_half_sweeps = 0

    def call(self, k: int):
        sol, hist = self.xt.als_spd_fused(self.A, self.x0[k], self.b,
                                          **self.args)
        self.f32_half_sweeps += len(hist)
        return sol

    @staticmethod
    def cores(sol) -> List[torch.Tensor]:
        return [c.to_torch() for c in sol.components]

    def counters(self) -> Dict[str, float]:
        return {**port.counters(), "f32_half_sweeps": self.f32_half_sweeps}


scope = port.scope
free = port.free
