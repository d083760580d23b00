"""The fused pre-codec pass's share of its roofline: the least time the
window's staged streams need at 3.35 TB/s (``counts.fused_precodec_bytes``
of each save's stream), over the device time of ``fused_precodec_kernel``
in the trace."""

from ckpt_bench.counts import HBM_BW, fused_precodec_bytes

KERNEL = "fused_precodec_kernel"


def read(rec):
    if rec.trace is None or not rec.saves:
        return None
    secs = sum(t for name, t in rec.trace.op_s.items() if KERNEL in name)
    if secs <= 0:
        return None
    words = [-(-s["stats"].raw_bytes // 4) for s in rec.saves]
    need = sum(fused_precodec_bytes(n, rec.chunk_size // 4) for n in words) / HBM_BW
    return 100.0 * need / secs
