"""The port's synthetic LM stream (``repro_torch.data.pipeline``) against
the JAX package's ``repro.data.pipeline`` on the CPU: the batches are
pure numpy in both, so they are held bitwise, for every config's smoke
variant (the vision and audio families' f32 memory included), through
``batch`` and through the prefetching ``iterator``, whose worker thread
must end when the iterator is closed."""
import threading

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro_torch import configs
from repro_torch.data import pipeline


def _pipes(arch, seq_len=40, global_batch=4, seed=3, **kw):
    return (jpipe.SyntheticLM(jconfigs.get_config(arch, smoke=True),
                              seq_len, global_batch, seed=seed, **kw),
            pipeline.SyntheticLM(configs.get_config(arch, smoke=True),
                                 seq_len, global_batch, seed=seed, **kw))


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batches_are_bitwise_the_jax_batches(arch):
    jp, tp = _pipes(arch)
    for step in (0, 1, 7, 1000):
        _same(tp.batch(step), jp.batch(step))
    b = tp.batch(0)
    assert b["tokens"].dtype == np.int32
    if tp.cfg.family in ("vlm", "audio"):
        assert b["memory"].dtype == np.float32


def test_shards_split_the_global_batch():
    jp, tp = _pipes("qwen2-1.5b", global_batch=8, shard=1, num_shards=2)
    got = tp.batch(5)
    _same(got, jp.batch(5))
    assert got["tokens"].shape == (4, 40)


def _worker_threads():
    return [t for t in threading.enumerate()
            if t.name == "SyntheticLM-prefetch" and t.is_alive()]


def test_iterator_replays_the_stream_from_start_step():
    jp, tp = _pipes("llama-3.2-vision-90b")
    it = tp.iterator(start_step=6, prefetch=2)
    try:
        for k in range(4):
            _same(next(it), jp.batch(6 + k))
    finally:
        it.close()


def test_closed_iterator_ends_its_thread():
    before = len(_worker_threads())
    _, tp = _pipes("qwen2-1.5b")
    it = tp.iterator(start_step=0, prefetch=1)
    next(it)
    assert len(_worker_threads()) == before + 1
    it.close()      # stops and joins the worker, even blocked on a full queue
    assert len(_worker_threads()) == before
