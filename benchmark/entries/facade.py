"""``LCS(...)(u=, v=, isglobal=True, truncation=T, resample=R)`` back to
back on a ring of host records, as one ``lcs-torch`` process does per
file.  The configuration states ``truncation`` (``null``: none) and
``resample`` (a fixed step in hours such as ``"12h"``; absent: none)."""
from benchmark import common as C
from benchmark.reference import facade as RF


class Entry(C.Base):

    def __init__(self, cfg, traffic, seed, device):
        from lagrangiancoherence_tpu_torch.api import LCS
        if not cfg.get("isglobal", True):
            raise ValueError("the facade's reference states the global path "
                             "only: a regional cell needs an entry of its "
                             "own")
        self.cfg = cfg
        self.lats, self.lons = C.coords(cfg)
        self.prog_records, self.arrays = [], []
        for s in range(traffic["ring"]):
            fu, fv, arrays = C.host_record(cfg, traffic, seed, s,
                                           cfg["levels"])
            self.prog_records.append((fu, fv))
            self.arrays.append(arrays)
        times = C.labels(cfg, cfg["levels"])
        self.resample = cfg.get("resample")
        if self.resample:
            times = RF.resample_labels(times, self.resample)
        self.stamp = times[0 if cfg["timestep_s"] < 0 else -1]
        self.prog_lcs = LCS(timestep=cfg["timestep_s"],
                            SETTLS_order=cfg["settls_order"], device=device)
        self.stamp_mismatch = 0
        for s in range(traffic["ring"]):
            self.call(s)
        self.stamp_mismatch = 0

    def call(self, i):
        fu, fv = self.prog_records[i % len(self.prog_records)]
        out = self.prog_lcs(u=fu, v=fv, isglobal=True,
                            truncation=self.cfg["truncation"],
                            resample=self.resample, verbose=False)
        self.stamp_mismatch += int(out.coords["time"][0] != self.stamp)
        return out

    def keep(self, i, out):
        return [(i % len(self.arrays), out.data[0])]

    def reference(self, slot, device, precision):
        u, v = self.arrays[slot]
        times = C.labels(self.cfg, self.cfg["levels"])
        return RF.lcs_ftle(u, v, self.lats, self.lons, self.cfg["timestep_s"],
                           settls_order=self.cfg["settls_order"],
                           truncation=self.cfg["truncation"], device=device,
                           dtype=C.PRECISIONS[precision][0],
                           tf32=C.PRECISIONS[precision][1],
                           times=times, resample=self.resample)

    def check(self, answers, device, stand_in=None):
        return (C.compare(self, answers, device, RF.COMMON_LATS, stand_in),
                {"stamp_mismatch": self.stamp_mismatch})
