"""The sweep profiler's grouping of device kernels by name."""

import pytest

from consensus_clustering_tpu_torch.profile_sweep import _kernel_class


@pytest.mark.parametrize("name,group", [
    ("void lloyd_step_kernel<true>(float const*, int const*, float const*)",
     "lloyd_step_kernel"),
    ("lloyd_reduce_kernel(float const*, float const*, int const*, int)",
     "lloyd_reduce_kernel"),
    ("void assign_kernel<false>(float const*, int const*)", "assign_kernel"),
    ("void fused_planes_kernel<true>(float const*, float const*, int)",
     "fused_planes_kernel"),
    ("hist_kernel(float const*, int, int)", "hist_kernel"),
    ("void hist_kernel<CountLoad, 4, long long>(CountLoad, long long)",
     "hist_kernel"),
    ("fused_merge_kernel(int const*, long long, int, int, int*)",
     "fused_merge_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8", "cublas gemm"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "CUDAFunctor_add<long>>(int, long)",
     "other (elementwise, reductions, copies)"),
])
def test_kernel_class_groups_each_kernel_under_its_own_name(name, group):
    # Both instantiations of a template kernel fall under one name.
    assert _kernel_class(name) == group
