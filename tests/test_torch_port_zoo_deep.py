"""The port's P3D-131 and P3D-199 at full depth against the JAX package's
(the harness and tolerances of tests/test_torch_port_zoo_p3d.py): eval
logits in f32, train-mode logits and updated statistics in f64, at
1x16x32x32 clips with full widths. Their blocks are P3D-63's; these hold
the depth (23 and 36 blocks in stage 3, 8 in stage 2 of P3D-199)."""

from test_torch_port_zoo_p3d import one_thread, pair_fixture  # noqa: F401

p3d131 = pair_fixture("p3d_131", (1, 8, 32, 32, 3))
p3d199 = pair_fixture("p3d_199", (1, 8, 32, 32, 3))


def test_p3d131_eval_logits_match_jax(p3d131):
    p3d131.check_eval()
    assert len(p3d131.tm.block_names) == 33


def test_p3d131_train_mode_logits_and_stats_match_jax(p3d131):
    p3d131.check_train()


def test_p3d199_eval_logits_match_jax(p3d199):
    p3d199.check_eval()
    assert len(p3d199.tm.block_names) == 50


def test_p3d199_train_mode_logits_and_stats_match_jax(p3d199):
    p3d199.check_train()
