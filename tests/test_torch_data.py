"""The port's data path (asva_tpu_torch/data/{datasets,multipair,loader}.py)
against asva_tpu's on the CPU.

Clips are written once by the port's writer (64x64, 12 fps, stereo 44.1 kHz
audio, so the resampler runs) and read by both packages: AudioVideoDataset
and MultiPairAVDataset items equal asva_tpu's within 1e-6 (video and
waveform; the same resize matrices, and a resampler whose fp32 sums run in
another order), text encodings exactly, under two seeds and two epochs, in
train and test mode, for each sampling type and through the decode-failure
walk.  The loader gives asva_tpu's index batches for every (seed, epoch,
shard, drop_last) tried, and keeps its own promises: thread mode equals
process mode and any worker count, resume, reset, shards, seed adoption,
errors, held batches.

All comparisons with asva_tpu's datasets and loader are in this one file,
and asva_tpu's media library is loaded once, in a module fixture (its lazy
build links straight onto its final name)."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from asva_tpu_torch.data import media
from asva_tpu_torch.data.loader import DataLoader

pytestmark = pytest.mark.skipif(not media.headers_available(),
                                reason="libav development files missing")
torch.set_num_threads(1)

SR = 44100


def _write(path, n_frames, fps=12.0, hw=(64, 64), seed=0, channels=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    frames = np.stack([
        np.stack([(xx * 3 + i * 7 + seed) % 256, (yy * 5 + i * 3) % 256,
                  (xx + yy + 40 * seed) % 256], -1)
        for i in range(n_frames)]).astype(np.uint8)
    frames = np.clip(frames + rng.integers(0, 8, frames.shape), 0,
                     255).astype(np.uint8)
    t = np.arange(int(n_frames / fps * SR)) / SR
    audio = np.stack([0.4 * np.sin(2 * np.pi * (300 + 50 * seed) * t),
                      0.2 * np.sin(2 * np.pi * 90 * t)])[:channels]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    media.write_video(path, frames, fps, audio.astype(np.float32), SR)


@pytest.fixture(scope="module")
def jax_data():
    """asva_tpu's dataset modules, its media library loaded once."""
    from test_torch_media import jax_media
    jax_media()
    from asva_tpu.data import datasets, multipair
    return datasets, multipair


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """dog/a, dog/b, cat/c (4 s), a 1 s clip too short for the multipair
    item, and a file that is no video; the class lists, the encodings as
    a class mapping (.npz + json) and as one tensor (.pt)."""
    root = tmp_path_factory.mktemp("avdata")
    names = ["dog/a.mp4", "dog/b.mp4", "cat/c.mp4"]
    for i, name in enumerate(names):
        _write(str(root / name), 48, seed=i, channels=2 - i % 2)
    _write(str(root / "cat/short.mp4"), 12, seed=3)
    (root / "cat" / "broken.mp4").write_bytes(b"not a video")
    (root / "train.txt").write_text("\n".join(names))
    (root / "clips.txt").write_text(
        "dog/a.mp4,0.5,3.5\ncat/c.mp4,1.0,3.2\n")
    (root / "pairs.txt").write_text("\n".join(
        ["dog/a.mp4", "cat/broken.mp4", "cat/short.mp4", "dog/b.mp4",
         "cat/c.mp4"]))
    rng = np.random.default_rng(1)
    np.savez(root / "enc.npz", **{
        c: rng.standard_normal((77, 768)).astype(np.float32)
        for c in ("a dog", "a cat")})
    (root / "mapping.json").write_text(json.dumps({"dog": "a dog",
                                                   "cat": "a cat"}))
    torch.save(torch.from_numpy(rng.standard_normal((1, 77, 768)).astype(
        np.float32)), root / "single.pt")
    return root


def _same_item(got, want, atol=1e-6):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        g, w = np.asarray(got[key]), np.asarray(value)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in ("text_encoding", "index"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


# ------------------------------------------------------------ datasets ---

@pytest.mark.parametrize("mode,seed", [("train", 0), ("train", 5),
                                       ("test", 0), ("test", 5)])
def test_audio_video_dataset_matches_jax(jax_data, root, mode, seed):
    """Every item in two epochs equals asva_tpu's: random clip starts and
    flips in train, centred clips in test, channel 0 resampled to 16 kHz;
    text encodings through the class mapping, the single tensor and the
    clip-list form."""
    from asva_tpu_torch.data.datasets import AudioVideoDataset
    jd = jax_data[0]
    forms = [
        dict(example_list_path=str(root / "train.txt"),
             class_mapping_json=str(root / "mapping.json"),
             class_text_encoding_mapping_path=str(root / "enc.npz")),
        dict(example_list_path=str(root / "clips.txt"),
             example_list_type="clip",
             class_text_encoding_mapping_path=str(root / "single.pt"))]
    for form in forms:
        kw = dict(form, data_root=str(root), mode=mode, img_size=(48, 40),
                  video_fps=6, video_num_frame=8, randflip=True, seed=seed)
        ours, ref = AudioVideoDataset(**kw), jd.AudioVideoDataset(**kw)
        items = []
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ref)):
                got, want = ours[i], ref[i]
                assert got["video"].shape == (8, 48, 40, 3)
                assert got["waveform"].shape == (int(8 / 6 * 16000),)
                _same_item(got, want)
                items.append(got["video"])
        if mode == "train":   # epochs draw new clip starts and flips
            n = len(ref)
            assert any(not np.array_equal(items[i], items[n + i])
                       for i in range(n))


@pytest.mark.parametrize("sampling_type", ["random-compact", "center-compact",
                                           "random", "uniform"])
def test_multipair_dataset_matches_jax(jax_data, root, sampling_type):
    """Every position of a list with an undecodable file and a too-short
    clip: the same walk to the next example (item["index"]) and the same
    k clips, flips and waveforms as asva_tpu's, in two epochs."""
    from asva_tpu_torch.data.multipair import MultiPairAVDataset
    jm = jax_data[1]
    kw = dict(example_list_path=str(root / "pairs.txt"), data_root=str(root),
              mode="train", image_size=32, video_fps=6, video_num_frames=4,
              randflip=True, shift_time=0.2, num_clips=5,
              sampling_type=sampling_type, seed=3)
    ours, ref = MultiPairAVDataset(**kw), jm.MultiPairAVDataset(**kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got, want = ours[i], ref[i]
            assert got["videos"].shape == (5, 4, 32, 32, 3)
            assert got["waveforms"].shape == (5, int(4 / 6 * 16000))
            _same_item(got, want)
    # the decode-failure walk: the broken file and the short clip move on
    assert [ours[i]["index"] for i in range(len(ours))] == [0, 3, 3, 3, 4]


def test_multipair_no_decodable_example(root, tmp_path):
    from asva_tpu_torch.data.multipair import MultiPairAVDataset
    lst = tmp_path / "bad.txt"
    lst.write_text("cat/broken.mp4\ncat/short.mp4\n")
    ds = MultiPairAVDataset(str(lst), str(root), num_clips=5, image_size=32,
                            video_num_frames=4)
    with pytest.raises(RuntimeError, match="no decodable example"):
        ds[0]
    with pytest.raises(ValueError, match="sampling_type"):
        MultiPairAVDataset(str(lst), str(root), sampling_type="nearest")


# -------------------------------------------------------------- loader ---

class Indices:
    """Items that name their index, (seed, epoch)-deterministic payloads."""

    def __init__(self, n=13, seed=0):
        self.n, self.seed, self.epoch = n, seed, 0

    def __len__(self):
        return self.n

    def set_epoch(self, e):
        self.epoch = e

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, self.epoch, i))
        return {"i": np.int64(i),
                "x": rng.standard_normal((4, 6)).astype(np.float32)}


def _ids(batches):
    return [b["i"].tolist() for b in batches]


def test_loader_batch_order_matches_jax():
    """asva_tpu's DataLoader and the port's give the same index batches in
    every (seed, epoch, shard, drop_last, shuffle) combination, and the
    same lengths."""
    from asva_tpu.data.loader import DataLoader as JaxLoader
    for seed in (0, 7):
        for shard in ((0, 1), (0, 2), (1, 2), (2, 3)):
            for drop_last in (True, False):
                for shuffle in (True, False):
                    kw = dict(batch_size=3, shuffle=shuffle, num_workers=1,
                              drop_last=drop_last, seed=seed, shard=shard)
                    ours = DataLoader(Indices(13), **kw)
                    ref = JaxLoader(Indices(13), **kw)
                    assert len(ours) == len(ref)
                    for _ in range(3):   # epochs 0, 1, 2
                        got, want = list(ours), list(ref)
                        assert _ids(got) == [b["i"].tolist() for b in want]
                        for g, w in zip(got, want):
                            assert isinstance(g["x"], torch.Tensor)
                            np.testing.assert_array_equal(g["x"].numpy(),
                                                          w["x"])
                    assert ours.state_dict() == ref.state_dict()


@pytest.fixture
def loaders():
    made = []

    def make(ds, batch_size=4, **kw):
        dl = DataLoader(ds, batch_size, **kw)
        made.append(dl)
        return dl

    yield make
    for dl in made:
        dl.close()


def test_loader_modes_and_worker_counts_agree(loaders):
    """Thread mode with 1 or 3 workers and process mode with 1 or 3 give
    the same batches in two epochs, as torch tensors."""
    runs = []
    for mode in ("thread", "process"):
        for workers in (1, 3):
            dl = loaders(Indices(13, seed=2), shuffle=True, seed=7,
                         num_workers=workers, worker_mode=mode)
            runs.append([[{k: v.clone() for k, v in b.items()} for b in dl]
                         for _ in range(2)])
            assert dl.state_dict() == {"epoch": 2, "cursor": 0, "seed": 7}
    first = runs[0]
    assert len(first[0]) == 3 and _ids(first[0]) != _ids(first[1])
    for run in runs[1:]:
        for ep_a, ep_b in zip(first, run):
            assert _ids(ep_a) == _ids(ep_b)
            for a, b in zip(ep_a, ep_b):
                assert a["x"].dtype == torch.float32
                assert a["i"].dtype == torch.int64
                assert torch.equal(a["x"], b["x"])


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_resume_fast_forward(loaders, mode):
    """A loader restored from another's state after 2 batches yields exactly
    the rest of the uninterrupted run, into the next epoch."""
    truth = loaders(Indices(13), shuffle=True, seed=11, num_workers=2)
    want = list(truth) + list(truth)
    run1 = loaders(Indices(13), shuffle=True, seed=11, num_workers=2,
                   worker_mode=mode)
    it = iter(run1)
    consumed = [next(it), next(it)]
    saved = run1.state_dict()
    it.close()
    assert saved == {"epoch": 0, "cursor": 2, "seed": 11}
    run2 = loaders(Indices(13), shuffle=True, seed=11, num_workers=2,
                   worker_mode=mode)
    run2.load_state_dict(saved)
    resumed = list(run2) + list(run2)
    assert _ids(consumed + resumed) == _ids(want)


def test_loader_resume_adopts_checkpoint_seed(loaders):
    """A restored loader with another configured seed adopts the saved one,
    in its shuffle and in the dataset's augmentation draws."""
    run1 = loaders(Indices(13, seed=7), shuffle=True, seed=7, num_workers=2)
    it = iter(run1)
    consumed = [next(it)]
    saved = run1.state_dict()
    it.close()
    run2 = loaders(Indices(13, seed=8), shuffle=True, seed=8, num_workers=2)
    run2.load_state_dict(saved)
    assert run2.seed == 7 and run2.dataset.seed == 7
    got = consumed + list(run2)
    want = list(loaders(Indices(13, seed=7), shuffle=True, seed=7,
                        num_workers=2))
    assert _ids(got) == _ids(want)
    for a, b in zip(got, want):
        assert torch.equal(a["x"], b["x"])


def test_loader_reset_and_shards(loaders):
    """reset() gives every early-stopping pass the same window without
    leaking producer threads; shards of 13 items in 2 give equal, disjoint
    batch lists."""
    dl = loaders(Indices(13), batch_size=1, num_workers=2, drop_last=False,
                 prefetch=1)
    before = threading.active_count()

    def take(n):
        dl.reset()
        out = []
        for i, b in enumerate(dl):
            if i >= n:
                break
            out.append(b["i"].item())
        return out
    assert take(2) == take(2) == [0, 1]
    assert threading.active_count() <= before + 1

    seen, counts = [], []
    for host in range(2):
        sl = loaders(Indices(13), batch_size=2, shuffle=True, seed=5,
                     num_workers=1, shard=(host, 2))
        batches = list(sl)
        counts.append(len(batches))
        seen.append(sorted(sum(_ids(batches), [])))
    assert counts == [3, 3]
    assert not set(seen[0]) & set(seen[1])


class Failing(Indices):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom")
        return super().__getitem__(i)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_worker_error_propagates(loaders, mode):
    """A worker's error raises in the consumer, every time; the process
    pool survives it, and a pool left by an early exit serves the rest of
    the epoch."""
    dl = loaders(Failing(13), shuffle=False, num_workers=2, worker_mode=mode)
    for _ in range(2):
        with pytest.raises((RuntimeError, ValueError), match="boom"):
            list(dl)
    if mode == "process":
        assert all(p.is_alive() for p in dl._pool.procs)
    good = loaders(Indices(13), shuffle=False, num_workers=2,
                   worker_mode=mode)
    it = iter(good)
    next(it)
    it.close()
    pool = good._pool
    assert _ids(list(good)) == [[4, 5, 6, 7], [8, 9, 10, 11]]
    assert good._pool is pool


def test_process_loader_held_batch_is_not_overwritten(loaders):
    """A batch held while later ones stream through the recycled slabs
    keeps its values (the slab is copied out before it is yielded)."""
    dl = loaders(Indices(40), shuffle=True, seed=3, num_workers=2,
                 worker_mode="process", prefetch=1)
    held = expect = None
    for i, b in enumerate(dl):
        if i == 0:
            held = b
            expect = {k: v.clone() for k, v in b.items()}
    for k in expect:
        assert torch.equal(held[k], expect[k])


def test_process_loader_multipair_items(root, loaders):
    """The real multipair dataset through the forked workers equals thread
    mode, batch for batch."""
    from asva_tpu_torch.data.multipair import MultiPairAVDataset

    def make(mode):
        ds = MultiPairAVDataset(str(root / "train.txt"), str(root),
                                mode="train", num_clips=3, shift_time=0.2,
                                video_fps=6, video_num_frames=4,
                                image_size=32, seed=5)
        return loaders(ds, batch_size=2, shuffle=True, num_workers=2, seed=5,
                       worker_mode=mode)
    bt, bp = list(make("thread")), list(make("process"))
    assert len(bt) == len(bp) == 1
    for key in ("index", "videos", "waveforms"):
        assert torch.equal(bt[0][key], bp[0][key])
