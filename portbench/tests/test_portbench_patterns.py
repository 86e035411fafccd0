"""Device items are grouped into layers by the pattern files."""

from portbench import spec
from portbench.trace import Trace, _union

NAMES = {
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<float, float, false>(int, float, float const*)": 1.0,
    "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel"
    "Template<float, float, 32u>(long, long)": 2.0,
    "void (anonymous namespace)::auction_kernel<true, true>(...)": 4.0,
    "void (anonymous namespace)::augment_kernel<4>(...)": 8.0,
    "void (anonymous namespace)::knn_xyz_kernel<16>(...)": 16.0,
    "void (anonymous namespace)::knn_ring_kernel<16>(...)": 32.0,
    "Memcpy DtoH (Device -> Pageable)": 64.0,
}


def trace():
    return Trace(steps=2, window_s=1.0, busy_s=0.5,
                 items={k: [v, 1] for k, v in NAMES.items()})


def test_layers_take_their_items():
    t = trace()
    assert t.seconds_matching(spec.patterns("norm")) == 3.0
    assert t.seconds_matching(spec.patterns("emd")) == 12.0
    # the ring scan (K9) is not the streaming scan (K8)
    assert t.seconds_matching(spec.patterns("knn")) == 16.0
    assert t.device_items == len(NAMES)
    assert t.top_items(2) == [["Memcpy DtoH (Device -> Pageable)", 64.0],
                              [next(k for k in NAMES if "ring" in k), 32.0]]


def test_union_of_intervals():
    assert _union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
