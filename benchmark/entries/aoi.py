"""Area-of-influence cases back to back on a ring of host records: each call
is one ``case(viwve, viwvn, tcwv, mslpres, pr)`` of the port's example
(stages 1-7 of LagrangianCoherence LCS/area_of_influence.py:90-295), on
five seeded float64 host Fields (``moisture.py``) in the configuration's
order.

The comparison holds each sampled case to the plain reference
(``reference/aoi.py``) stage by stage.  Both log-FTLE fields are compared
by ``common.field_errors``' rules.  Each later stage's reference is fed the
program's own output of the stage before, so that one pixel flipped near a
threshold does not cascade:

* ``threshold_mismatch``: pixels whose local-threshold mask differs where
  the local log-FTLE lies farther than ``DIAG_REL`` of the threshold's
  largest value from the threshold;
* ``ridge_mask_mismatch``: ridge pixels that differ where none of the
  ridge tests (the sign of the eigenvalue kept, which eigenvalue is kept,
  ``|dt_prod| <= tolerance``) lies within ``DIAG_REL`` of its threshold;
* ``skeleton_mismatch``: pixels of the thinned mask that differ (exact);
* ``filter_mismatch``: components of either filter kept differently,
  leaving out those whose criterion lies within ``DIAG_REL`` of its
  threshold;
* ``rain_rel_err``: the four rain sums' largest gap over the total rain.

Over the window: ``stamp_mismatch`` (calls whose FTLE time labels break
the facade's rule) and ``empty_case`` (sampled cases in which a stage came
out empty).
"""
import numpy as np

from benchmark import common as C
from benchmark import moisture as M
from benchmark.reference import aoi as RA
from benchmark.reference import facade as RF

DIMS = ("time", "latitude", "longitude")
# a mask or a component may differ where its test lies within this share of
# the tested quantity's scale of its threshold (chip_smoke.py's DIAG_REL)
DIAG_REL = 1e-3
STAGES = ("threshold_mask", "ridges_raw", "skeleton", "ridges",
          "ridges_high_gradient", "cz_mask", "local_strain")
RAIN = ("total_rain", "rain_on_czs", "rain_on_local_strain",
        "rain_remainder")


def records(cfg, traffic, seed, slot) -> dict:
    """Case ``slot``'s five (levels, ny, nx) float64 host arrays."""
    lats, lons = C.coords(cfg)
    spec = traffic["fields"]
    return M.fields_numpy(M.draw(spec, seed, slot), spec, lats, lons,
                          cfg["levels"])


def stamps(cfg) -> tuple:
    """The time labels the facade gives the window's and the local FTLE."""
    times = C.labels(cfg, cfg["levels"])
    window = RF.resample_labels(times[-cfg["window_levels"]:],
                                cfg["resample"])
    local = times[-cfg["local_levels"]:]
    back = cfg["timestep_s"] < 0
    return tuple(t[0] if back else t[-1] for t in (window, local))


class Entry(C.Base):

    def __init__(self, cfg, traffic, seed, device):
        from lagrangiancoherence_tpu_torch.examples import area_of_influence
        from lagrangiancoherence_tpu_torch.field import Field
        self.case, self.cfg, self.device = area_of_influence.case, cfg, device
        self.lats, self.lons = C.coords(cfg)
        coords = {"time": C.labels(cfg, cfg["levels"]),
                  "latitude": self.lats, "longitude": self.lons}
        self.arrays = [records(cfg, traffic, seed, s)
                       for s in range(traffic["ring"])]
        self.prog_records = [{k: Field(a, DIMS, coords, name=k)
                              for k, a in arr.items()}
                             for arr in self.arrays]
        self.want_stamps = stamps(cfg)
        self.stamp_mismatch = 0
        for s in range(traffic["ring"]):     # every shape, every kernel
            self.call(s)
        self.stamp_mismatch = 0

    def call(self, i):
        out = self.case(**self.prog_records[i % len(self.prog_records)],
                        coarse_factor=self.cfg["coarse_factor"],
                        device=self.device)
        self.stamp_mismatch += int(tuple(out["stamps"]) != self.want_stamps)
        return out

    def keep(self, i, out):
        ans = {k: np.asarray(out[k].data if hasattr(out[k], "dims")
                             else out[k])
               for k in ("log_ftle", "log_ftle_local", "eigvectors")
               + STAGES}
        ans.update({k: out[k] for k in RAIN})
        return [(i % len(self.arrays), ans)]

    def reference(self, slot, device, precision):
        """Both log-FTLE fields of case ``slot`` (ascending coordinates) in
        one of ``common.PRECISIONS``."""
        cfg, arr = self.cfg, self.arrays[slot]
        dtype, tf32 = C.PRECISIONS[precision]
        times = C.labels(cfg, cfg["levels"])
        u, v = arr["viwve"] / arr["tcwv"], arr["viwvn"] / arr["tcwv"]
        out = []
        for levels, resample, scale in (
                (cfg["window_levels"], cfg["resample"], lambda x: x / 2),
                (cfg["local_levels"], None, lambda x: x * 4)):
            norm, _ = RA.regional_ftle(
                u[-levels:], v[-levels:], self.lats, self.lons,
                cfg["timestep_s"], settls_order=cfg["settls_order"],
                times=times[-levels:], resample=resample, device=device,
                dtype=dtype, tf32=tf32)
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(scale(np.log(norm)))
        return tuple(out)

    def check(self, answers, device, stand_in=None):
        refs = self.__dict__.setdefault("references", {})

        def ref(key, precision):
            if (key, precision) not in refs:
                refs[key, precision] = self.reference(key, device, precision)
            return refs[key, precision]

        rows = np.ones(self.cfg["grid"]["ny"], dtype=bool)
        per, empty = [], 0
        for slot, ans in answers:
            got = ref(slot, stand_in) if stand_in else (
                ans["log_ftle"], ans["log_ftle_local"])
            errs = [C.field_errors(np.asarray(g), w, f, rows)
                    for g, w, f in zip(got, ref(slot, "float64"),
                                       ref(slot, "float32"))]
            nums = {k: max(e[k] for e in errs) for k in errs[0]}
            nums["stable_share"] = min(e["stable_share"] for e in errs)
            if not stand_in:
                nums.update(self.stage_numbers(slot, ans))
                empty += int(any(not np.nansum(np.asarray(ans[k]) > 0)
                                 for k in STAGES))
            per.append(nums)
        whole = {"stamp_mismatch": self.stamp_mismatch}
        if not stand_in:
            whole["empty_case"] = empty
        return per, whole

    def stage_numbers(self, slot, ans) -> dict:
        """Stages 4-7 of a sampled case against the reference fed the
        program's own output of the stage before."""
        cfg, arr = self.cfg, self.arrays[slot]
        lat_a, lon_a = np.sort(self.lats), np.sort(self.lons)
        # 4. the local threshold of the program's local log-FTLE
        local = ans["log_ftle_local"]
        th = cfg["threshold"]
        block = min(th["block_cap"], (min(local.shape) // 2) * 2 + 1)
        thr = RA.threshold_local(local, block, th["offset"])
        far = np.abs(local - thr) > DIAG_REL * np.nanmax(np.abs(thr))
        threshold = int(((ans["threshold_mask"] > 0) != (local > thr))
                        [far].sum())
        # 5. ridges of the program's log-FTLE, thinning of its ridge mask,
        # components of its skeleton
        rg = cfg["ridges"]
        r = RA.hessian_ridges(ans["log_ftle"], lat_a, lon_a, rg["sigma"],
                              rg["tolerance"])
        lam = max(np.abs(r["lam0"]).max(), np.abs(r["lam1"]).max())
        near = ((np.abs(r["eigmin"]) <= DIAG_REL * lam)
                | (np.abs(np.abs(r["lam0"]) - np.abs(r["lam1"]))
                   <= DIAG_REL * lam)
                | (np.abs(np.abs(r["dt_prod"]) - rg["tolerance"])
                   <= DIAG_REL * np.abs(r["dt_prod"]).max()))
        ridges = int(((ans["ridges_raw"] > 0) != (r["ridges"] > 0))
                     [~near].sum())
        skeleton = int((RA.zhang_suen(ans["ridges_raw"])
                        != (ans["skeleton"] > 0)).sum())
        filt = self._filter_mismatch(ans["skeleton"], ans["log_ftle"],
                                     cfg["filter"], ans["ridges"])
        # 6. the pressure-gradient filter of the program's filtered ridges,
        # with its eigenvectors
        mslp = RA.interp_to(arr["mslpres"][-1], self.lats, self.lons, lat_a,
                            lon_a)
        grad = RA.pressure_along_ridges(mslp, ans["eigvectors"], lat_a, lon_a)
        filt += self._filter_mismatch(ans["ridges"], ans["ridges"] * grad,
                                      cfg["pressure_filter"],
                                      ans["ridges_high_gradient"])
        # 7. the rain of the program's filtered ridges and local mask
        pr = RA.interp_to(arr["pr"][-1], self.lats, self.lons, lat_a, lon_a)
        want = RA.rain(pr, ans["ridges"], ans["threshold_mask"],
                       cfg["distance"])
        total = max(abs(want["total_rain"]), 1e-300)
        rain = max(abs(ans[k] - want[k]) for k in RAIN) / total
        return {"threshold_mismatch": threshold,
                "ridge_mask_mismatch": ridges,
                "skeleton_mismatch": skeleton, "filter_mismatch": filt,
                "rain_rel_err": float(rain)}

    @staticmethod
    def _filter_mismatch(mask, intensity, thresholds, got) -> int:
        """Components of ``mask`` that the program kept (``got`` > 0)
        otherwise than the reference, leaving out those with a criterion
        within ``DIAG_REL`` of its threshold."""
        comp = RA.components(mask, intensity)
        if not comp["n"]:
            return int(np.nansum(np.asarray(got) > 0))
        keep = RA.kept(comp, thresholds)
        near = np.zeros(comp["n"], dtype=bool)
        for crit, thr in thresholds.items():
            near |= np.abs(comp[crit] - thr) <= DIAG_REL * abs(thr)
        lab = comp["labels"]
        inside = lab > 0
        kept_px = np.nan_to_num(np.asarray(got, np.float64))[inside] > 0
        prog = np.zeros(comp["n"], dtype=bool)
        np.logical_or.at(prog, lab[inside] - 1, kept_px)
        outside = (~inside) & (np.nan_to_num(np.asarray(got)) > 0)
        return int(((prog != keep) & ~near).sum() + outside.any())
