"""Dry run: build and run EVERY (architecture × input-shape) cell on the
production meshes on fake tensors, print its costs and memory, and dump the
roofline terms to ``reports/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k --mesh single                                  # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi      # 512 ranks
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu      # no card

The port's counterpart of ``repro.launch.dryrun``. Where the reference
forces 512 host devices and compiles ahead of time, ``main`` starts a fake
process group (``torch.testing._internal.distributed.fake_pg``: every rank's
collectives return at once and move nothing) of
``launch.mesh.required_devices`` ranks in its own process, builds the
production mesh on it with tensors of ``--device``'s type, and runs each
cell's program once as rank 0 on fake tensors under ``launch.cost``'s mode
(``launch.steps.lower_cell``). Nothing is allocated, on the card or off it.

Eager counting has no rolled loop to undercount, so the two shallow probes
of ``_probe_costs`` give the full depth's costs exactly (a test holds it);
they stay because they save running the deep archs layer by layer. With
probes the memory is extrapolated the same way: arguments and outputs are
affine in depth, and so is the peak where its place in the program does not
move with depth; without probes it is the full-depth run's own.

The fit check is against the H100's 80 GB (``fits_80gb_hbm``), where the
reference checks a v5e's 16 GiB.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh, required_devices
from repro_torch.launch.steps import build_cell, lower_cell

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
HBM_BYTES = 80e9          # one H100's HBM3

PROBE_DEPTHS = (4, 8)     # shallow accounting probes (see _probe_costs)
_MEMORY = ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")


def _probe_cfg(cfg, depth: int):
    kw = {"num_layers": depth, "scan_unroll": True}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _cell_costs(cfg, cell, mesh):
    """flops, bytes, collective bytes and memory of one run of the cell."""
    rec = lower_cell(build_cell(cfg, cell, mesh), mesh)
    cost = rl.cost_analysis_dict(rec)
    return (cost["flops"], cost["bytes accessed"], rl.collective_bytes(rec),
            {k: getattr(rec, k) for k in _MEMORY})


def _probe_costs(cfg, cell, mesh):
    """Full-depth flops/bytes/collectives (and memory) from two shallow
    probes: every layer of a group runs the same ops, so the count is affine
    in the layer count, total(L) = base + per_layer·L, and the extrapolation
    is exact. (For hymba the 3 global layers are constant across probes and
    the SWA count is L-3 — still affine in L.)"""
    d1, d2 = PROBE_DEPTHS
    f1, b1, c1, m1 = _cell_costs(_probe_cfg(cfg, d1), cell, mesh)
    f2, b2, c2, m2 = _cell_costs(_probe_cfg(cfg, d2), cell, mesh)
    L = cfg.num_layers

    def extrap(v1, v2):
        slope = (v2 - v1) / (d2 - d1)
        return max(v1 + slope * (L - d1), 0.0)

    flops = extrap(f1, f2)
    byts = extrap(b1, b2)
    coll = {k: int(extrap(c1[k], c2[k])) for k in c1}
    mem = {k: int(extrap(m1[k], m2[k])) for k in m1}
    return flops, byts, coll, mem


def run_cell(arch: str, shape: str, multi_pod: bool, *, save: bool = True,
             verbose: bool = True, probes: bool = True,
             overrides: dict | None = None, tag: str = "", device: str = "cuda") -> dict:
    """Run one cell on the production mesh of an initialized (fake) world of
    ``required_devices(multi_pod)`` ranks, with ``device``-type tensors."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = "multi2x16x16" if multi_pod else "single16x16"
    chips = mesh.size()

    t0 = time.time()
    if probes:
        flops, byts, coll, mem = _probe_costs(cfg, cell, mesh)
    else:
        flops, byts, coll, mem = _cell_costs(cfg, cell, mesh)
    t_run = time.time() - t0

    roof = rl.Roofline(
        arch=cfg.name, cell=cell.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll,
        model_flops=rl.model_flops(cfg, cell),
    )
    out = {
        "status": "ok",
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "device": device,
        "probes": probes,
        "run_s": round(t_run, 1),
        "memory": dict(mem),
        **roof.to_dict(),
    }
    peak = mem["peak_bytes"]
    out["memory"]["per_device_gb"] = round(peak / 1e9, 3)
    out["fits_80gb_hbm"] = peak < HBM_BYTES

    if verbose:
        print(f"[{arch} × {shape} × {mesh_name}] {'probes' if probes else 'full depth'} "
              f"{t_run:.0f}s")
        print(f"  memory: args={mem['argument_bytes']/1e9:.2f}GB "
              f"peak={peak/1e9:.2f}GB per device (fits 80GB: {out['fits_80gb_hbm']})")
        print(f"  costs: flops={roof.hlo_flops:.3e} bytes={roof.hlo_bytes:.3e}")
        print(f"  collectives: { {k: f'{v/2**20:.1f}MiB' for k, v in roof.coll_bytes.items() if v} }")
        print(f"  roofline: compute={roof.t_compute*1e3:.3f}ms "
              f"memory={roof.t_memory*1e3:.3f}ms "
              f"collective={roof.t_collective*1e3:.3f}ms "
              f"→ {roof.bottleneck}-bound, useful={roof.useful_ratio:.3f}")

    if save:
        REPORTS.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = REPORTS / f"{arch}__{shape}__{mesh_name}{suffix}.json"
        fn.write_text(json.dumps(out, indent=2))
    return out


def start_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process, as rank
    0; raises if a group exists already or the backend is missing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already: the dry run needs "
                           "its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
        raise RuntimeError(f"not a fake world of {world_size} ranks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--skip-probes-multi", action="store_true", default=True,
                    help="multi-pod pass: one full-depth run, no probes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors and the mesh (nothing is allocated)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    results, failures = [], []
    for mp in meshes:   # each mesh in a fake world of its own size
        if dist.is_initialized():
            dist.destroy_process_group()
        start_fake_world(required_devices(multi_pod=mp))
        for arch in archs:
            cfg = get_config(arch)
            for shape in shapes:
                if not applicable(cfg, SHAPES[shape]):
                    print(f"[{arch} × {shape}] SKIP (long-context needs "
                          f"sub-quadratic attention)")
                    continue
                try:
                    results.append(run_cell(arch, shape, mp, device=args.device,
                                            probes=not (mp and args.skip_probes_multi)))
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[{arch} × {shape} × {'multi' if mp else 'single'}] "
                          f"FAILED: {e}")
                    traceback.print_exc()
                    if not args.continue_on_error:
                        return 1

    print("\n=== ROOFLINE TABLE ===")
    print(rl.format_table(results))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nAll {len(results)} cells ran successfully.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
