#!/usr/bin/env python3
"""Time each layout of K2m, the serving warp, on one CUDA card, and hold
each against its plain version.

    python3 scripts/warp_mesh_layouts.py

K2m (csrc/warp.cu, `warp_mesh_kernel<PIX>`) runs one pixel per thread in
blocks of 8 rows or four in blocks of 4 rows; `ops.cuda_warp.warp_mesh_pix`
picks one per call.  This script launches each layout directly at the main
path's shapes (288 x 512 frames on the 4 x 4 mesh; the frame a view of the
13-channel input stack: planes at S=1, 2, 4 and 6 as `assemble_input` hands
it over, channels last at S=10 as the debug forward does), and prints one
JSON line per shape: each layout's device time and the empty kernel's at
its grid (`cuda_warp.empty_launch`, the launch floor), all by
chip_smoke.device_ms (20 calls in a CUDA graph, median of 50 replays); the
layout the wrapper picks; the bound (bytes over the card's rate, as
chip_smoke counts them); and whether each layout equals `warp_mesh_plain`
bit for bit on all four planes.  Then the same check, untimed, at a ragged
width (289 x 515) and on an 8 x 8 mesh.  A last line names the card and its
power limit.  Exits 1 if a layout disagrees.  Needs CUDA; imports nothing
of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from stabnet_tpu_torch.ops import cuda_build, cuda_warp, mesh_tables  # noqa: E402

PIX = (1, 4)


def helpers():
    """This checkout's chip_smoke.py (timing helpers and inputs)."""
    spec = importlib.util.spec_from_file_location("layouts_chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def equal_each(frame, Hs, tables):
    want = cuda_warp.warp_mesh_plain(frame, Hs, tables)
    ok = {}
    for pix in PIX:
        got = cuda_warp._launch_warp_mesh(frame, Hs, tables, pix)
        torch.cuda.synchronize()
        ok[f"pix{pix}"] = all(torch.equal(a, b) for a, b in zip(got, want))
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_mesh_layouts: CUDA is not available", file=sys.stderr)
        return 1
    cs = helpers()
    cuda_build.build(["warp"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bw = cs.peaks(torch.cuda.get_device_name(0))[0]
    H, W = 288, 512
    failed = False
    for S, channels_last in ((1, False), (2, False), (4, False), (6, False), (10, True)):
        frame = cs.stack_frame(S, H, W, gen, dev, channels_last)
        Hs = cs.realistic_homographies(S, gen, dev)
        tables = mesh_tables(H, W, 4, 4, dev)
        nbytes = 4 * (5 * S * H * W + Hs.numel() + 2 * (H + W))
        res = {"S": S, "frame": "channels last" if channels_last else "planes",
               "bound_us": nbytes / bw * 1e6, "bytes": nbytes,
               "picked": cuda_warp.warp_mesh_pix(S, H, W, frame.stride(2))}
        for pix in PIX:
            res[f"pix{pix}_us"] = 1e3 * cs.device_ms(
                lambda: cuda_warp._launch_warp_mesh(frame, Hs, tables, pix))
            res[f"empty_pix{pix}_us"] = 1e3 * cs.device_ms(
                lambda: cuda_warp.empty_launch(S, H, W, pix, dev))
        res["equal"] = equal_each(frame, Hs, tables)
        failed |= not all(res["equal"].values())
        print(json.dumps(res), flush=True)
    for S, (h, w), g in ((1, (289, 515), 4), (6, (289, 515), 4), (2, (H, W), 8),
                         (6, (289, 515), 8)):
        for channels_last in (False, True):
            frame = cs.stack_frame(S, h, w, gen, dev, channels_last)
            Hs = cs.realistic_homographies(S, gen, dev, grid=g)
            ok = equal_each(frame, Hs, mesh_tables(h, w, g, g, dev))
            failed |= not all(ok.values())
            print(json.dumps({"S": S, "hw": [h, w], "mesh": g, "channels_last": channels_last,
                              "equal": ok}), flush=True)
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
