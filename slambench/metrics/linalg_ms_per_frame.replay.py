"""Dense algebra (``ops/linalg.py`` through cuBLAS and cuSOLVER): its
kernels' device time a replayed frame.

A kernel is the library's by its name, by the table below, frozen with the
benchmark: cuBLAS's and cuSOLVER's kernels as the profiler names them on
the H100 (GEMM / GEMV in their SM90 and CUTLASS forms, the triangular
solves and products, potrf's panels and its helpers)."""

import re

LIBRARY = re.compile(
    r"gemm|gemv|xmma|cutlass|cublas|cusolver|trsm|trmm|trsv|syrk|herk|"
    r"syr2k|symm|symv|potrf|potrs|getrf|getrs|geqrf|orgqr|ormqr|larf|lacpy|"
    r"laset|laswp|splitKreduce|dot_kernel|nrm2|scal_kernel|axpy_kernel|"
    r"magma|chol", re.IGNORECASE)


def read(t, cell):
    if not t.frames or not t.device:
        return None
    return sum(t.kernel_us(lambda n: bool(LIBRARY.search(n)))) / t.frames / 1e3
