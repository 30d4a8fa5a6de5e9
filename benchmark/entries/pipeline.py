"""Whole FTLE fields back to back from a ring of wind stacks made on the
card: one ``FTLEPipeline`` built once (the mix's ``call`` is
``"FTLEPipeline"``, the default), or ``ftle_pipeline`` a field, which
builds its grid state at every call (``"ftle_pipeline"``)."""
import numpy as np
import torch

from benchmark import common as C
from benchmark import winds as W


class Entry(C.Base):

    def __init__(self, cfg, traffic, seed, device):
        from lagrangiancoherence_tpu_torch.grid import Grid
        from lagrangiancoherence_tpu_torch.models import pipeline
        lats, lons = C.coords(cfg)
        lats, lons = np.sort(lats), np.sort(lons)
        self.cfg, self.lats, self.lons = cfg, lats, lons
        self.dtype = getattr(torch, cfg["dtype"])
        ring = traffic["ring"]
        self.params = [W.draw(traffic["winds"], seed, s, ring)
                       for s in range(ring)]
        self.prog_stacks = [W.stack_torch(p, lats, lons, cfg["levels"],
                                          self.dtype, device)
                            for p in self.params]
        grid = Grid(lats=lats, lons=lons, cyclic_x=cfg["cyclic_x"])
        kw = dict(settls_order=cfg["settls_order"],
                  interp_order=cfg["interp_order"], engine=cfg["engine"])
        call = traffic.get("call", "FTLEPipeline")
        if call == "FTLEPipeline":
            model = pipeline.FTLEPipeline(grid, dtype=self.dtype,
                                          device=device, **kw)
            self.prog_model = lambda u, v: model(u, v, cfg["timestep_s"],
                                                 return_overflow=True)
        elif call == "ftle_pipeline":
            self.prog_model = lambda u, v: pipeline.ftle_pipeline(
                u, v, cfg["timestep_s"], grid, return_overflow=True,
                device=device, **kw)
        else:
            raise ValueError(f"unknown call {call!r} in the traffic mix")
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)
        for s in range(ring):      # every stack, every kernel
            self.call(s)
        self.overflow.zero_()

    def call(self, i):
        u, v = self.prog_stacks[i % len(self.prog_stacks)]
        out, ovf = self.prog_model(u, v)
        self.overflow |= ovf
        return out

    def keep(self, i, out):
        return [(i % len(self.params), out)]     # to the host after the window

    def reference(self, slot, device, precision):
        u, v = W.stack_torch(self.params[slot], self.lats, self.lons,
                             self.cfg["levels"], self.dtype, device)
        return C.reference_ftle(self.cfg, u, v, self.lats, self.lons,
                                precision)

    def check(self, answers, device, stand_in=None):
        return (C.compare(self, answers, device, self.lats, stand_in),
                {"overflow": int(self.overflow)})
