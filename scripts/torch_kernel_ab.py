#!/usr/bin/env python3
"""Time the port's warp kernels and its serving warp in several checkouts
on one CUDA card, in turns.

    python3 scripts/torch_kernel_ab.py parent=<dir> change=. change=. parent=<dir>

Each `label=dir` runs, in the order given, in a process of its own with
`dir`'s `stabnet_tpu_torch` first on the path (its kernels built from its own
csrc/), and prints one JSON line: K2 at (1, 288, 512, 1), (10, 288, 512, 2)
and (20, 288, 512, 1) on mesh maps; K2m (`cuda_warp.warp_mesh`, device
time, and where the checkout has it the empty kernel at the grid K2m picks)
and `ops.warp.transformer(U, mesh, 4, 4)` under inference mode at S=1, 4, 6
and 10, U the current frame as a view of the 13-channel input stack, as the
serving path hands it over (channels last at S=10, as the debug forward
does; device time and time per call from the host; whatever chain the
checkout runs); the
serving step at S=1 (v2_93 bf16, random weights, 720p): device operations
and kernel time per frame over 10 frames and the wall time per frame over
20 (chip_smoke.profile_path); K1 (device time and time per call from the
host) and K3
(where the checkout has it) at 720p S=1 and S=4 and at 1080p S=1; K4 at
(10, 288, 512, 2) on the mesh maps with each pass's device time under
torch.profiler.  Device times are medians of CUDA-graph replays
(chip_smoke.device_ms), host times of single calls (chip_smoke.call_ms).
The timing helpers come from this checkout's chip_smoke.py.  A last line
names the card and its power limit.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def helpers():
    """This checkout's chip_smoke.py, loaded under its own name so that a
    checkout on the path cannot shadow it."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(label: str, root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from stabnet_tpu_torch.ops import (base_mesh, cuda_build, cuda_warp, mesh_tables,
                                       mesh_to_homographies, resize_bilinear_bhw)
    from stabnet_tpu_torch.ops.warp import transformer

    assert cuda_build.PKG_DIR.startswith(os.path.abspath(root)), cuda_build.PKG_DIR
    cs = helpers()
    cuda_build.build(["warp", "warp_grad"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    res = {"label": label, "root": root}
    H, W = 288, 512
    for B, C in ((1, 1), (10, 2), (20, 1)):
        im = (torch.rand((B, H, W, C), generator=gen) - 0.5).to(dev)
        xm, ym = cs.realistic_maps(B, H, W, gen, dev)
        res[f"K2 ({B}, {H}, {W}, {C})"] = cs.device_ms(lambda: cuda_warp.bilinear_sample(im, xm, ym))
    # The serving warp at the path's batches: S=1 (online), 4 (chip_smoke's
    # clip), 6 (the bench's batch) on the stack as `assemble_input` lays it
    # out, 10 (the debug forward's batch) on a channels-last stack.
    tables = mesh_tables(H, W, 4, 4, dev)
    for S in (1, 4, 6, 10):
        U = cs.stack_frame(S, H, W, gen, dev, channels_last=S == 10)
        mesh = torch.from_numpy(base_mesh(4, 4))
        mesh = (mesh + 0.05 * torch.randn((S, 5, 5, 2), generator=gen)).to(dev)
        with torch.inference_mode():
            Hs = mesh_to_homographies(mesh, 4, 4)
            res[f"K2m S={S}"] = cs.device_ms(lambda: cuda_warp.warp_mesh(U, Hs, tables))
            if hasattr(cuda_warp, "empty_launch"):
                pix = cuda_warp.warp_mesh_pix(S, H, W, U.stride(2))
                res[f"K2m S={S} pixels per thread"] = pix
                res[f"empty kernel at K2m's S={S} grid"] = cs.device_ms(
                    lambda: cuda_warp.empty_launch(S, H, W, pix, dev))
            warp = lambda: transformer(U, mesh, 4, 4)
            res[f"transformer S={S} device_ms"] = cs.device_ms(warp)
            res[f"transformer S={S} call_ms"] = cs.call_ms(warp)
    # The serving step at S=1 (v2_93 bf16, seeded random weights, 720p):
    # device operations and kernel time per frame, under chip_smoke's
    # profile (10 frames of a fresh engine: no steady wall time).
    from stabnet_tpu_torch.config import V2_93
    from stabnet_tpu_torch.stream import StreamEngine

    engine = StreamEngine(cs.random_model(V2_93, 0), V2_93, device=dev)
    clip = cs.make_clips(1, 21, cs.CLIP_HW)[0]
    wall, _, busy, ops, _ = cs.profile_path(engine, clip, frames=10)
    res.update({"step S=1 kernel ms": busy, "step S=1 device ops per frame": ops})
    # Host time per serving frame, the step's launches and its readback
    # included, over 20 frames after 10 of warm-up (median of 3 runs).
    res["step S=1 wall ms/frame"] = sorted(cs.profile_path(engine, clip, frames=20)[0]
                                           for _ in range(3))[1]
    del engine
    for shape, S, hw in (("S=1 720p", 1, (720, 1280)), ("S=4 720p", 4, (720, 1280)),
                         ("S=1 1080p", 1, (1080, 1920))):
        imc = torch.randint(0, 256, (S, 3) + hw, generator=gen, dtype=torch.uint8).to(dev)
        xm, ym = cs.realistic_maps(S, 288, 512, gen, dev)
        xs = resize_bilinear_bhw(xm, (72, 128)).contiguous()
        ys = resize_bilinear_bhw(ym, (72, 128)).contiguous()
        k1 = lambda: cuda_warp.warp_uint8_cf_lowres(imc, xs, ys, hw)
        res[f"K1 {shape}"] = cs.device_ms(k1)
        res[f"K1 {shape} call_ms"] = cs.call_ms(k1)
        if hasattr(cuda_warp, "warp_uint8_cf"):
            xf = resize_bilinear_bhw(xs, hw).contiguous()
            yf = resize_bilinear_bhw(ys, hw).contiguous()
            res[f"K3 {shape}"] = cs.device_ms(lambda: cuda_warp.warp_uint8_cf(imc, xf, yf))
    xm, ym = cs.realistic_maps(10, H, W, gen, dev)
    g = (torch.rand((10, H, W, 2), generator=gen) - 0.5).to(dev)
    kern = lambda: cuda_warp.bilinear_splat(g, xm, ym, (H, W))
    res["K4 (10, 288, 512, 2)"] = cs.device_ms(kern)
    res["K4 passes"] = cs.kernel_passes(kern)
    return res


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    runs = [a.split("=", 1) for a in argv]
    if not runs or any(len(r) != 2 for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    for label, root in runs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", label, root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    print(helpers().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
