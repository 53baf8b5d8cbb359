"""The port's serving slice against the JAX package: Tagger.scores_from,
rank_tags, Tagger.tag on a decoded video, the one-call tag() and
iter_pack_tags over a decode-once pack.

Both taggers run r2plus1d_18 at full depth in f32 on the same seeded uint8
frames and the same weights (JAX init, carried across by
models/convert.py); the JAX side uses its plain XLA convs, the port its
kernel route, which on CPU tensors is the kernels' plain versions.
Scores agree within 1e-4 (f32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastvideotagging_tpu import config as jcfg
from fastvideotagging_tpu.evaluation import tagger as jtagger
from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch import tag as ttag
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data import synthetic
from fastvideotagging_tpu_torch.evaluation import tagger as ttagger
from fastvideotagging_tpu_torch.models.convert import from_jax_variables

NUM_CLASSES = 5
SCORE_ATOL = 1e-4


def _cfgs(multilabel: bool, eval_mode: str = "dense"):
    def build(c, kernels):
        return c.ExperimentConfig(
            model=c.ModelConfig(name="r2plus1d_18", num_classes=NUM_CLASSES,
                                multilabel=multilabel, kernels=kernels,
                                compute_dtype="float32"),
            data=c.DataConfig(resize_hw=(40, 56), crop_hw=(32, 32),
                              sampler=c.ClipSamplerConfig(
                                  clip_len=4, stride=2, eval_mode=eval_mode,
                                  num_eval_clips=3)))
    return build(jcfg, "xla"), build(tcfg, "cuda")


@pytest.fixture(scope="module")
def weights():
    model = jget_model("r2plus1d_18", num_classes=NUM_CLASSES, dtype=jnp.float32)
    x = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, train=False)
    # perturb the BN stats and affine so eval BN is not the identity
    rng = np.random.default_rng(3)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + (rng.uniform(0.0, 0.1, a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), variables)
    return variables, from_jax_variables(variables)


@pytest.fixture(scope="module")
def taggers(weights):
    variables, state = weights
    out = {}
    for multilabel in (True, False):
        jc, tc = _cfgs(multilabel)
        out[multilabel] = (jtagger.Tagger(jc, variables, clip_batch=2),
                           ttagger.Tagger(tc, state, clip_batch=2, device="cpu"))
    return out


def _frames(h, w, n=21):
    return synthetic.make_frames(2, num_frames=n, height=h, width=w, seed=5)


@pytest.mark.parametrize("multilabel", [True, False])
def test_scores_from_matches_jax_at_ship_geometry(taggers, multilabel):
    jt, tt = taggers[multilabel]
    frames = _frames(40, 56)
    ref = jt.scores_from(lambda i: frames[i], len(frames))
    got = tt.scores_from(lambda i: frames[i], len(frames))
    assert got.shape == (NUM_CLASSES,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)
    names = [f"t{i}" for i in range(NUM_CLASSES)]
    assert ([r.index for r in ttagger.rank_tags(got, names, threshold=0.0)]
            == [r.index for r in jtagger.rank_tags(ref, names, threshold=0.0)])


def test_scores_from_resizes_other_geometry(taggers):
    # both sides resize with their C tier (the JAX package's default), bit
    # for bit (tests/test_torch_port_framepack.py)
    jt, tt = taggers[True]
    frames = _frames(48, 64)
    ref = jt.scores_from(lambda i: frames[i], len(frames))
    got = tt.scores_from(lambda i: frames[i], len(frames))
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)


def test_iter_eval_chunks_matches_jax():
    jc, _ = _cfgs(True)
    frames = _frames(40, 56)
    idx = jtagger.eval_clip_index(len(frames), jc.data.sampler)
    np.testing.assert_array_equal(
        idx, ttagger.eval_clip_index(len(frames), jc.data.sampler))
    want = list(jtagger.iter_eval_chunks(lambda i: frames[i], idx, (40, 56), 2))
    got = list(ttagger.iter_eval_chunks(lambda i: frames[i], idx, (40, 56), 2))
    assert [n for _, n in got] == [n for _, n in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rank_tags_threshold_and_topk():
    scores = np.array([0.2, 0.9, 0.5, 0.9, 0.1], np.float32)
    names = list("abcde")
    for kw in (dict(threshold=0.5), dict(threshold=0.0, top_k=2), dict(threshold=1.1)):
        got = ttagger.rank_tags(scores, names, **kw)
        want = jtagger.rank_tags(scores, names, **kw)
        assert [(r.tag, r.score, r.index) for r in got] == [
            (r.tag, r.score, r.index) for r in want]


def test_tag_video_file_matches_jax(tmp_path, taggers, weights):
    frames = _frames(40, 56, n=19)
    path = str(tmp_path / "clip.mp4")
    synthetic.write_video(path, frames)
    jt, tt = taggers[True]
    ref = jt.tag(path, threshold=0.0)
    got = tt.tag(path, threshold=0.0)
    assert [r.index for r in got] == [r.index for r in ref]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in ref],
                               rtol=0, atol=SCORE_ATOL)
    # the one-call API, from the JAX variables, on the CPU
    variables, _ = weights
    _, tc = _cfgs(True)
    one = ttag(path, variables=variables, cfg=tc, threshold=0.0, device="cpu")
    assert [r.index for r in one] == [r.index for r in got]
    np.testing.assert_allclose([r.score for r in one], [r.score for r in got],
                               rtol=0, atol=SCORE_ATOL)


def test_iter_pack_tags_matches_jax(tmp_path, taggers):
    items = [(f"clip{i}.mp4", i, (i,), _frames(40, 56, n=n)) for i, n in enumerate((21, 9))]
    path = str(tmp_path / "videos.fvtpack")
    tpacked.write_pack_from_arrays(items, path, (40, 56), NUM_CLASSES)
    jt, tt = taggers[True]
    want = list(jtagger.iter_pack_tags(jt, path, threshold=0.0, root="r"))
    got = list(ttagger.iter_pack_tags(tt, path, threshold=0.0, root="r"))
    assert [p for p, _ in got] == [p for p, _ in want] == ["r/clip0.mp4", "r/clip1.mp4"]
    for (_, a), (_, b) in zip(got, want):
        assert [r.index for r in a] == [r.index for r in b]
        np.testing.assert_allclose([r.score for r in a], [r.score for r in b],
                                   rtol=0, atol=SCORE_ATOL)
    other = str(tmp_path / "other.fvtpack")
    tpacked.write_pack_from_arrays([("x.mp4", 0, (0,), _frames(40, 48))], other, (40, 48))
    with pytest.raises(ValueError, match="ship geometry"):
        next(ttagger.iter_pack_tags(tt, other))
