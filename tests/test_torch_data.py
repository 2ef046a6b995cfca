"""The port's data pipeline against the JAX package's: batches bit-equal
for the dense, VLM and audio families (any row slice), the input specs,
and the prefetching loader's order from its start step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import batch_specs as jbatch_specs  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data import (DataLoader, SyntheticLMDataset,  # noqa: E402
                              batch_specs, make_batch)

ARCHS = ["qwen2-0.5b", "llava-next-mistral-7b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_bit_equal_to_reference(arch):
    """``make_batch`` at two steps, and rows [1, 3) of a batch, equal the
    reference's array for array (tokens, labels and the frontend's
    embeddings: patches for the VLM, frames for audio)."""
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    for step in (0, 5):
        got = make_batch(tcfg, 24, 4, step=step, seed=3)
        want = jmake_batch(jcfg, 24, 4, step=step, seed=3)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    kw = dict(frontend_len=tcfg.frontend_len, frontend_dim=tcfg.d_model,
              family=tcfg.family)
    got = SyntheticLMDataset(tcfg.vocab, 24, 4, seed=3, **kw).batch(2, 1, 3)
    want = JDataset(jcfg.vocab, 24, 4, seed=3, **kw).batch(2, 1, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    want = jbatch_specs(jcfg, 1024, 8)
    got = batch_specs(tcfg, 1024, 8)
    assert got.keys() == want.keys()
    for k, s in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == s.shape
        assert str(got[k].dtype)[6:] == str(s.dtype)


def test_loader_order_from_start_step():
    """The loader yields (step, batch) from ``start_step`` on, each batch
    the dataset's for that step as tensors on the device; ``close`` stops
    its thread."""
    ds = SyntheticLMDataset(vocab=50, seq_len=8, global_batch=2, seed=1)
    loader = DataLoader(ds, start_step=4, prefetch=2, device="cpu")
    try:
        for want_step in (4, 5, 6):
            step, batch = next(loader)
            assert step == want_step
            for k, v in ds.batch(step).items():
                assert batch[k].device.type == "cpu"
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
