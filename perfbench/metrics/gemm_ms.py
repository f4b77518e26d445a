"""``gemm_ms``: device milliseconds a step of the matrix-product kernels
(cuBLAS)."""


def read(trace):
    seconds = trace.groups_s.get("gemm", 0.0)
    return 1e3 * seconds / trace.steps if seconds > 0 else None
