"""repro_torch.data.pipeline against the JAX package's pipeline: the
corpus and the batches (tokens, labels, and the vision and audio inputs
drawn beside them) are equal, element for element, for the arches of
tests/test_data.py, staged file tier -> host tier through each package's
own DataUnit."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.core import make_backend as ref_make_backend  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.core import make_backend  # noqa: E402
from repro_torch.data.pipeline import (BatchPipeline,  # noqa: E402
                                       corpus_data_unit, synthesize_corpus)


@pytest.mark.parametrize("vocab,n,seed", [(1000, 10_000, 3), (256, 200_000, 0),
                                          (128256, 50_000, 1)])
def test_corpus_equals_the_reference(vocab, n, seed):
    got = synthesize_corpus(vocab, n, seed=seed)
    np.testing.assert_array_equal(
        got, ref_pipeline.synthesize_corpus(vocab, n, seed=seed))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < vocab


@pytest.mark.parametrize("arch", ["llama3_2_1b", "internvl2_2b",
                                  "whisper_base"])
def test_batches_equal_the_reference(arch, tmp_path):
    cfg, rcfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
    du = corpus_data_unit(
        "c", cfg, num_tokens=200_000, num_shards=4,
        backends={"file": make_backend("file", root=tmp_path / "port"),
                  "host": make_backend("host")})
    rdu = ref_pipeline.corpus_data_unit(
        "c", rcfg, num_tokens=200_000, num_shards=4,
        backends={"file": ref_make_backend("file", root=tmp_path / "ref"),
                  "host": ref_make_backend("host")})
    du.to_tier("host", delete_source=False)
    rdu.to_tier("host", delete_source=False)
    pipe = BatchPipeline(du, cfg, batch=4, seq_len=64)
    rpipe = ref_pipeline.BatchPipeline(rdu, rcfg, batch=4, seq_len=64)
    try:
        for _ in range(3):
            b, rb = next(pipe), next(rpipe)
            assert sorted(b) == sorted(rb)
            for k in b:
                assert b[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(b[k], rb[k])
            assert b["tokens"].shape == (4, 64)
            np.testing.assert_array_equal(b["tokens"][:, 1:],
                                          b["labels"][:, :-1])
            if cfg.vision_tokens:
                assert b["patch_embeds"].shape == (4, cfg.vision_tokens,
                                                   cfg.vision_embed_dim)
            if cfg.encoder_layers:
                assert b["frames"].shape == (4, cfg.encoder_seq_len,
                                             cfg.d_model)
    finally:
        pipe.close()
        rpipe.close()
