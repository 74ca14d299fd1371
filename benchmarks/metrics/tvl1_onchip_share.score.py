"""Kernels (`ops/flow.py`, `csrc/tvl1.cu`): the share of the scored clips'
TV-L1 pixel updates made by K7's on-chip launches (a warp's iterations in
one launch, the image held in a thread-block cluster's shared memory), in
%: 100 x the counter `tvl1_onchip_px` over the counter `tvl1_px` of the
program's `score.pairs` spans under `score.clip`.  None where the program
keeps no such counter (one without the on-chip launches)."""

from benchmarks import spans


def read(rec):
    kept = spans.program_spans(rec, "score.clip")
    pairs = [s for s in kept or () if s.name == "score.pairs"]
    if not any("tvl1_onchip_px" in s.counters for s in pairs):
        return None
    px = spans.total(pairs, "score.pairs", "tvl1_px")
    return 100.0 * spans.total(pairs, "score.pairs", "tvl1_onchip_px") / px if px else None
