"""The profiler arithmetic on a hand-made trace."""
from eigbench.harness.profile import Trace, WINDOW_MARK, kernel_name


def _trace():
    device = [(0.0, 30.0, "kernel", "void spmm_blocksparse_kernel<float, 4>"
               "(float const*)", None),
              (20.0, 50.0, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
               3000),
              (70.0, 80.0, "kernel", "void gram_vec_kernel<4>(float4*)",
               None),
              (95.0, 130.0, "kernel", "tsgemm_vec_kernel", None)]
    host = [(0.0, 100.0, WINDOW_MARK), (0.0, 100.0, "eigbench.solve"),
            (55.0, 65.0, "aten::linalg_cholesky_ex"),
            (58.0, 62.0, "cudaStreamSynchronize")]
    return Trace(window=(0.0, 100.0), device=device, host=host)


def test_busy_union_idle_and_copies():
    t = _trace()
    assert t.busy_intervals() == [[0.0, 50.0], [70.0, 80.0], [95.0, 100.0]]
    assert abs(t.busy_s() - 65e-6) < 1e-12 and t.window_s == 100e-6
    gaps = dict(t.idle_gaps())
    assert abs(gaps["cudaStreamSynchronize"] - 20e-6) < 1e-12
    assert abs(gaps["eigbench.solve"] - 15e-6) < 1e-12
    nbytes, secs = t.copies("HtoD")
    assert nbytes == 3000 and abs(secs - 30e-6) < 1e-12


def test_kernels_by_name():
    t = _trace()
    assert kernel_name("void a::b_kernel<float, 4, (x)1>(float const*, int)"
                       ) == "a::b_kernel"
    ops = dict(t.device_ops())
    assert abs(ops["spmm_blocksparse_kernel"] - 30e-6) < 1e-12
    assert abs(ops["tsgemm_vec_kernel"] - 5e-6) < 1e-12   # clipped
    assert t.count(r"gram_(vec_)?kernel$") == 1
