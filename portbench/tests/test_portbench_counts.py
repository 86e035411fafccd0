"""Work counts against hand counts at small shapes."""

from types import SimpleNamespace

from portbench import spec
from portbench.tests.tiny import tiny_cell


def ctx_for(cell):
    return SimpleNamespace(cell=cell)


def test_linear_flops_autoencoder_by_hand():
    cell = tiny_cell("pn2_ae.train_cd_emd.b32n2048")  # B=2 N=128 P=32/8
    b, n = 2, 128
    rows_in_out = [
        (b * 32 * 32, [3, 64, 64, 128]),          # SA1: 32 centroids x 32
        (b * 8 * 32, [131, 128, 128, 256]),       # SA2: 8 centroids x 32
        (b * 8, [259, 256, 512, 1024]),           # SA3: all 8 points
        (b * 8, [1280, 256, 256]),                # FP3 onto level 2
        (b * 32, [384, 256, 128]),                # FP2 onto level 1
        (b * n, [128, 128, 128]),                 # FP1 onto the input
        (b * n, [128, 64, 3]),                    # head
    ]
    fwd = sum(2 * rows * ci * co for rows, ws in rows_in_out
              for ci, co in zip(ws[:-1], ws[1:]))
    flops, nbytes = spec.work("linear")(ctx_for(cell))
    assert (flops, nbytes) == (3 * fwd, 0)


def test_linear_flops_upsampler_by_hand():
    cell = tiny_cell("pu_3pu.serve.b32n2048x4")  # B=2 N=64, forward only
    b, n, k = 2, 64, 16
    fwd = 2 * (b * n * 3 * 24                                  # lift
               + b * n * k * (48 * 24 + 48 * 24 + 72 * 24)     # edge1
               + b * n * k * (192 * 24 + 120 * 24 + 144 * 24)  # edge2
               + b * n * 4 * (170 * 128 + 128 * 128)           # expand
               + b * n * 4 * (128 * 64 + 64 * 3))              # head
    assert spec.work("linear")(ctx_for(cell)) == (fwd, 0)


def test_emd_and_knn_work_by_hand():
    emd_cell = SimpleNamespace(traffic={"batch": 3, "points": 5})
    assert spec.work("emd")(ctx_for(emd_cell)) == (8 * 3 * 25,
                                                  3 * 5 * (24 + 4))
    knn_cell = SimpleNamespace(traffic={"batch": 2, "points": 4},
                               config={"k": 2})
    # 2 * 4 * 4 distances at 8 flops; 2 * 4 points read twice (12 bytes
    # each) and 3 neighbours written (8 bytes each)
    assert spec.work("knn")(ctx_for(knn_cell)) == (2 * 16 * 8,
                                                  2 * 4 * (24 + 24))


def test_roofline_takes_the_larger_bound():
    from portbench.harness import Context

    ctx = Context.__new__(Context)
    ctx.peaks = {"f32_flops_per_s": 10.0, "hbm_bytes_per_s": 100.0}
    assert ctx.roofline(20.0, 100.0) == 2.0
    assert ctx.roofline(5.0, 1000.0) == 10.0
