"""The port's asynchronous real-image pipeline (train/loader.py) against
``ImageBank.sample`` and against the JAX package's ``PrefetchLoader`` on
the same images and seeds: with hflip off its stream is bit for bit a loop
of ``bank.sample(rng, batch)``, and a data-parallel group's ranks' rows
(``rank``, ``world``) concatenate to it; with and without hflip it gives
the JAX loader's batches, and the ranks' rows concatenate to the one-process
batch; ``close()`` (and leaving the context) joins the producer
thread; a decode failure surfaces on the consumer."""

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.train.datasets import ImageBank
from where2edit_tpu_torch.train.loader import PrefetchLoader

N, SIZE, BATCH = 10, 8, 4


def _images() -> np.ndarray:
    return np.random.default_rng(0).uniform(-1, 1, (N, SIZE, SIZE, 3)).astype(np.float32)


def _shards(bank, world: int, **kw) -> list:
    """One loader per rank of a ``world``-rank group, each with the same
    seeds."""
    return [PrefetchLoader(bank, BATCH, rng=np.random.default_rng(3), rank=r, world=world,
                           workers=2, prefetch=2, **kw) for r in range(world)]


def test_torch_loader_stream_is_bank_sample():
    bank = ImageBank(images=_images())
    want_rng = np.random.default_rng(3)
    with PrefetchLoader(bank, BATCH, rng=np.random.default_rng(3), workers=2,
                        prefetch=2) as loader:
        for _ in range(5):
            got = next(loader)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert np.array_equal(got.numpy(), bank.sample(want_rng, BATCH))
    # two ranks' rows of the same stream
    want_rng = np.random.default_rng(3)
    shards = _shards(bank, 2)
    try:
        for _ in range(5):
            rows = [next(s).numpy() for s in shards]
            assert all(r.shape[0] == BATCH // 2 for r in rows)
            assert np.array_equal(np.concatenate(rows), bank.sample(want_rng, BATCH))
    finally:
        for s in shards:
            s.close()


@pytest.mark.parametrize("world", [2, 4])
def test_torch_loader_sharded_rows_concatenate_to_the_batch(world):
    """With flips on, each rank draws the global index and flip stream and
    keeps its rows: the ranks' batches concatenate to the one-process
    batch; a batch that does not split is refused."""
    bank = ImageBank(images=_images())
    (whole,) = _shards(bank, 1, hflip=True, flip_seed=4)
    shards = _shards(bank, world, hflip=True, flip_seed=4)
    try:
        for _ in range(4):
            want = next(whole).numpy()
            assert np.array_equal(np.concatenate([next(s).numpy() for s in shards]), want)
    finally:
        for s in [whole, *shards]:
            s.close()
    with pytest.raises(ValueError, match="does not split"):
        PrefetchLoader(bank, BATCH, rng=np.random.default_rng(0), rank=0, world=3)


@pytest.mark.parametrize("hflip", [False, True])
def test_torch_loader_matches_jax(hflip):
    from where2edit_tpu.train.datasets import ImageBank as JaxImageBank  # noqa: PLC0415
    from where2edit_tpu.train.loader import PrefetchLoader as JaxLoader  # noqa: PLC0415

    images = _images()
    want = JaxLoader(JaxImageBank(images=images), BATCH, rng=np.random.default_rng(7),
                     workers=2, hflip=hflip, flip_seed=11, device_put=False)
    got = PrefetchLoader(ImageBank(images=images), BATCH, rng=np.random.default_rng(7),
                         workers=2, hflip=hflip, flip_seed=11)
    try:
        batches = [(next(got).numpy(), np.asarray(next(want))) for _ in range(6)]
    finally:
        got.close()
        want.close()
    for a, b in batches:
        assert np.array_equal(a, b)
    if hflip:  # some image of the stream was flipped
        plain = np.random.default_rng(7)
        bank = ImageBank(images=images)
        assert any(not np.array_equal(a, bank.sample(plain, BATCH)) for a, _ in batches)


def test_torch_loader_flip_stream_continues_from_a_generator():
    """A resumed run hands the loader a flip Generator already moved past
    the batches it took: the stream continues as the uninterrupted one."""
    bank = ImageBank(images=_images())
    with PrefetchLoader(bank, BATCH, rng=np.random.default_rng(1), hflip=True,
                        flip_seed=5) as full:
        whole = [next(full).numpy() for _ in range(4)]
    rng, flips = np.random.default_rng(1), np.random.default_rng(5)
    for _ in range(2):
        rng.integers(0, N, size=BATCH)
        flips.random(BATCH)
    with PrefetchLoader(bank, BATCH, rng=rng, hflip=True, flip_seed=flips) as resumed:
        rest = [next(resumed).numpy() for _ in range(2)]
    for a, b in zip(whole[2:], rest):
        assert np.array_equal(a, b)


def test_torch_loader_close_joins_the_producer():
    loader = PrefetchLoader(ImageBank(images=_images()), BATCH,
                            rng=np.random.default_rng(2), workers=1, prefetch=1)
    next(loader)
    assert loader._producer.is_alive()  # blocked on the full queue
    loader.close()
    assert not loader._producer.is_alive()
    with PrefetchLoader(ImageBank(images=_images()), BATCH,
                        rng=np.random.default_rng(2)) as ctx:
        next(ctx)
    assert not ctx._producer.is_alive()


def test_torch_loader_surfaces_a_producer_failure():
    class Broken(ImageBank):
        def _load_one(self, i):
            raise OSError("unreadable image")

    loader = PrefetchLoader(Broken(images=_images()), BATCH, rng=np.random.default_rng(0))
    try:
        with pytest.raises(RuntimeError, match="unreadable image"):
            next(loader)
    finally:
        loader.close()
    with pytest.raises(ValueError):
        PrefetchLoader(ImageBank(images=_images()), 0, rng=np.random.default_rng(0))
