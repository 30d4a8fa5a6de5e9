"""``ftle_series`` over a month-long host record, called back to back;
every window of every call is stamped, and a sample of windows drawn from
the seed is compared."""
import numpy as np
import torch

from benchmark import common as C


class Entry(C.Base):

    def __init__(self, cfg, traffic, seed, device):
        from lagrangiancoherence_tpu_torch.runners import ftle_series
        self.ftle_series, self.device, self.cfg = ftle_series, device, cfg
        self.traffic = traffic
        nt = traffic["record_levels"]
        self.prog_u, self.prog_v, (u, v) = C.host_record(
            {**cfg, "input_dtype": cfg["dtype"]}, traffic, seed, 0, nt)
        lats, lons = C.coords(cfg)
        self.u, self.lats, self.lons = C.ascending(u, lats, lons)
        self.v = C.ascending(v, lats, lons)[0]
        self.starts = list(range(0, nt - cfg["levels"] + 1,
                                 traffic["stride"]))
        self.units_per_call = len(self.starts)
        rng = np.random.default_rng([seed % (1 << 64), 1 << 20])
        self.sampled = sorted(rng.choice(
            len(self.starts), min(traffic["sample_windows"],
                                  len(self.starts)), replace=False).tolist())
        back = cfg["timestep_s"] < 0
        self.stamps = C.labels(cfg, nt)[[s if back else s + cfg["levels"] - 1
                                         for s in self.starts]]
        self.stamp_mismatch = 0
        self.call(0)
        self.stamp_mismatch = 0

    def call(self, i):
        out = self.ftle_series(
            self.prog_u, self.prog_v, self.cfg["timestep_s"],
            window=self.cfg["levels"], stride=self.traffic["stride"],
            settls_order=self.cfg["settls_order"],
            interp_order=self.cfg["interp_order"], batch="auto",
            engine=self.cfg["engine"], device=self.device)
        self.stamp_mismatch += int(not np.array_equal(out.coords["time"],
                                                      self.stamps))
        return out

    def keep(self, i, out):
        return [(w, out.data[w].copy()) for w in self.sampled]

    def reference(self, w, device, precision):
        sl = slice(self.starts[w], self.starts[w] + self.cfg["levels"])
        u = torch.as_tensor(self.u[sl], device=device)
        v = torch.as_tensor(self.v[sl], device=device)
        return C.reference_ftle(self.cfg, u, v, self.lats, self.lons,
                                precision)

    def check(self, answers, device, stand_in=None):
        return (C.compare(self, answers, device, self.lats, stand_in),
                {"stamp_mismatch": self.stamp_mismatch})
