"""The port's S3D, S3D-G and I3D against the JAX package's (the harness and
tolerances of tests/test_torch_port_zoo_p3d.py): eval logits in f32, and
train-mode logits and updated statistics in f64, at 16x32x32 clips with
full widths. At this clip S3D's T falls 8 -> 4 -> 2 through the strided
pools and its spatial extent 8 -> 4 -> 2 -> 1, so the routing sends some
separable convs to K1 / K2 and leaves the others (the stride-2 stem, C < 32,
H < 3) on the library conv; I3D's stem takes TF-SAME's asymmetric pads."""

from test_torch_port_zoo_p3d import one_thread, pair_fixture, routed_sites  # noqa: F401

s3d = pair_fixture("s3d", (1, 16, 32, 32, 3))
# two clips: S3D-G's f32 gates feed mixed5's batch statistics, which one
# clip leaves at two samples a channel (T = 2, 1x1), where f64 cannot hide
# the gates' f32 rounding (the JAX module computes them in f32 too)
s3d_g = pair_fixture("s3d_g", (2, 16, 32, 32, 3))
i3d = pair_fixture("i3d", (1, 16, 32, 32, 3))


def test_s3d_eval_logits_match_jax(s3d, monkeypatch):
    s3d.check_eval()
    # K1 takes conv3 (64 channels at 8x8) and the b1_sep / b2_sep spatial
    # factors of mixed3b/3c at 4x4 whose input has >= 32 channels (b1 96 /
    # 128, b2 32 of mixed3c; mixed3b's b2 has 16); mixed4* and 5* sit at
    # 2x2 and 1x1. K2 takes every temporal factor but the stem's (stride 2)
    # and mixed5's (T = 2 stays eligible): conv3 + 2 x 9 blocks.
    assert routed_sites(s3d.tm, s3d.x, monkeypatch) == (4, 19)


def test_s3d_train_mode_logits_and_stats_match_jax(s3d):
    s3d.check_train()


def test_s3d_g_eval_logits_match_jax(s3d_g):
    s3d_g.check_eval()
    assert s3d_g.tm.mixed3b.b1_sep.gate.weight.shape == (128, 128)
    assert s3d_g.tm.stem.gate is not None


def test_s3d_g_train_mode_logits_and_stats_match_jax(s3d_g):
    s3d_g.check_train()


def test_i3d_eval_logits_match_jax(i3d):
    i3d.check_eval()


def test_i3d_train_mode_logits_and_stats_match_jax(i3d):
    i3d.check_train()


def test_tf_same_pads_match_jax_and_reach_the_conv():
    """The port's copy of tf_same_pads equals the JAX package's; I3D's
    7x7x7 stride-2 stem pads (2, 3) on an even 32 (asymmetric: an F.pad
    before the conv) and (3, 3) on an odd 33."""
    from fastvideotagging_tpu.ops.arch_spec import tf_same_pads as jpads
    from fastvideotagging_tpu_torch.models.layers import _conv_pads
    from fastvideotagging_tpu_torch.ops.arch_spec import tf_same_pads

    for size in range(1, 40):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                assert tf_same_pads(size, k, s) == jpads(size, k, s)
    assert _conv_pads("SAME", (7, 7, 7), (2, 2, 2), (16, 32, 33)) == ((2, 3), (2, 3), (3, 3))
    assert _conv_pads("SYM", (3, 7, 1), (1, 1, 1), (4, 4, 4)) == ((1, 1), (3, 3), (0, 0))
    assert _conv_pads(((0, 1), (1, 0), (2, 2)), (1, 1, 1), (1, 1, 1), (4, 4, 4)) == (
        (0, 1), (1, 0), (2, 2))


def test_s3d_and_i3d_bn_epsilon_is_1e3(s3d, i3d):
    for pair in (s3d, i3d):
        eps = {mod.epsilon for mod in pair.tm.modules() if hasattr(mod, "epsilon")}
        assert eps == {1e-3}, (pair.name, eps)
