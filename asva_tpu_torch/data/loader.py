"""Prefetching batch loader, thread or process workers.  Port of
asva_tpu/data/loader.py: the same batch order, per-item RNG, shards and
resume state, yielding dicts of torch tensors (pinned when a CUDA card is
present, so that `parallel.multihost.make_global_batch` copies them to the
card without blocking the host).

  * "thread" (default): a thread pool decodes each batch's items.
  * "process": forked worker processes decode items straight into shared
    slabs (anonymous shared memory mapped before the fork; the parent
    never unpickles an item's arrays: a 21-clip multipair item is about
    150 MB).  A finished slab is copied into a fresh tensor before it is
    yielded, and only then handed back to the workers: a batch stays valid
    while the consumer holds it, and an asynchronous copy to the card never
    reads memory that a worker is writing.  The pool is forked at the
    first iteration, usually after the parent has initialised CUDA: a
    worker runs the dataset's numpy and torch CPU code only, with one
    torch thread (an OpenMP pool inherited across the fork can hang), and
    never touches the card.

Determinism and resume: the shuffle order is a function of (seed, epoch);
datasets with `set_epoch` get the epoch, so their (seed, epoch, index)
augmentation draws do not depend on the worker count or mode.  The loader
tracks (epoch, batch cursor); `state_dict()` / `load_state_dict()` let a
resumed run skip the batches the interrupted run consumed (the reference
skips consumed steps within the epoch, scripts/animation_train.py:268-309).
`shard=(index, count)` gives each process an equal share of every epoch.
"""
from __future__ import annotations

import logging
import mmap
import queue
import random
import threading
import time
from typing import Iterator, Tuple

import numpy as np
import torch

log = logging.getLogger("asva_tpu_torch")


def _empty_batch(spec: dict, n: int) -> dict:
    """{key: uninitialised (n, *shape) tensor} for an item spec, pinned
    where there is a card to copy it to."""
    pin = torch.cuda.is_available()
    return {k: torch.empty((n,) + shape, dtype=dtype, pin_memory=pin)
            for k, (shape, dtype) in spec.items()}


def _item_spec(item: dict) -> dict:
    """{key: (shape, torch dtype)} of one item."""
    spec = {}
    for k, v in item.items():
        t = torch.from_numpy(np.asarray(v))
        spec[k] = (tuple(t.shape), t.dtype)
    return spec


def _collate(items) -> dict:
    batch = _empty_batch(_item_spec(items[0]), len(items))
    for i, item in enumerate(items):
        for k, t in batch.items():
            t[i] = torch.from_numpy(np.ascontiguousarray(item[k]))
    return batch


class _SlabPool:
    """Shared batch slabs: each holds one batch, key -> (batch_size,
    *item_shape) numpy array over an anonymous shared mapping.  Created
    before the workers fork, so children write into the parent's pages
    (no names, no pickling, no /dev/shm)."""

    def __init__(self, item: dict, batch_size: int, n_slabs: int):
        self.maps, self.slabs = [], []
        for _ in range(n_slabs):
            slab = {}
            for key, v in item.items():
                a = np.asarray(v)
                shape = (batch_size,) + a.shape
                nbytes = int(np.prod(shape)) * a.dtype.itemsize
                m = mmap.mmap(-1, max(nbytes, 1))
                self.maps.append(m)
                slab[key] = np.ndarray(shape, a.dtype, buffer=m)
            self.slabs.append(slab)

    def close(self):
        self.slabs = []
        for m in self.maps:
            try:
                m.close()
            except BufferError:   # a view is still alive; freed with it
                pass
        self.maps = []


def _process_worker(dataset, slabs, task_q, result_q):
    """Worker-process main: decode items into the shared slabs.  Tasks:
    (slab_id, slot, dataset_index, epoch), or None to exit."""
    torch.set_num_threads(1)
    last_epoch = None
    while True:
        task = task_q.get()
        if task is None:
            return
        slab_id, slot, index, epoch = task
        try:
            if epoch != last_epoch and hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
                last_epoch = epoch
            item = dataset[index]
            for key, arr in slabs[slab_id].items():
                arr[slot] = np.asarray(item[key], dtype=arr.dtype)
            result_q.put((slab_id, slot, None))
        except Exception as e:  # surface to the parent, keep the worker up
            result_q.put((slab_id, slot,
                          f"{type(e).__name__}: {e} (item {index})"))


class _ProcessPool:
    """Persistent fork pool and slab ring of a DataLoader in process mode;
    one pool serves every epoch of its loader."""

    def __init__(self, dataset, batch_size: int, num_workers: int,
                 n_slabs: int, probe_item: dict):
        import multiprocessing as mp
        ctx = mp.get_context("fork")   # inherit the dataset and the slabs
        self.spec = _item_spec(probe_item)
        self.slabs = _SlabPool(probe_item, batch_size, n_slabs)
        self.task_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self.procs = [ctx.Process(
            target=_process_worker,
            args=(dataset, self.slabs.slabs, self.task_q, self.result_q),
            daemon=True) for _ in range(num_workers)]
        for p in self.procs:
            p.start()

    def close(self):
        try:
            for _ in self.procs:
                self.task_q.put(None)
            for p in self.procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
        finally:
            self.slabs.close()
            for q in (self.task_q, self.result_q):
                q.close()


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = True,
                 seed: int = 0, shard: Tuple[int, int] = (0, 1),
                 prefetch: int = 4, worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(worker_mode)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._pool = None     # lazy _ProcessPool (process mode)
        self.epoch = 0        # epoch the NEXT __iter__ will (re)enter
        self._cursor = 0      # batches already consumed within that epoch

    def __len__(self):
        idx, n = self.shard
        per_host = len(self.dataset) // n if n > 1 else len(self.dataset)
        if self.drop_last:
            return per_host // self.batch_size
        return (per_host + self.batch_size - 1) // self.batch_size

    # -- resume state --
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "cursor": self._cursor,
                "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        saved_seed = state.get("seed")
        if saved_seed is not None and int(saved_seed) != self.seed:
            # the cursor counts batches of the SAVED seed's shuffle order,
            # and the dataset's augmentation draws are (seed, epoch,
            # index)-derived: adopt the checkpoint's seed in both, or the
            # resumed run would re-train some examples and skip others
            log.warning(
                "DataLoader resume: checkpoint seed %s != configured seed "
                "%s; adopting the checkpoint seed to keep the consumed-"
                "batch cursor meaningful", saved_seed, self.seed)
            self.seed = int(saved_seed)
            if hasattr(self.dataset, "seed"):
                self.dataset.seed = int(saved_seed)

    def reset(self) -> None:
        """Forget epoch and cursor: the next __iter__ starts at the top.
        For stateless passes that may stop early (an in-train eval):
        without it, the cursor would slide each pass's window."""
        self.epoch = 0
        self._cursor = 0

    def _indices(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        idx, n = self.shard
        if n > 1:
            # equal per-process length (DistributedSampler semantics):
            # unequal batch counts would pair one process's steps with
            # another's next epoch, or leave one waiting in a collective
            order = order[:(len(order) // n) * n]
            return order[idx::n]
        return order

    def _epoch_batches(self):
        order = self._indices()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        # fast-forward past the consumed batches: no decode happens for them
        return batches[self._cursor:]

    def close(self) -> None:
        """Tear down the process workers and slabs (no-op otherwise)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _iter_process(self) -> Iterator[dict]:
        batches = self._epoch_batches()
        if not batches:
            self.epoch += 1
            self._cursor = 0
            return
        if self._pool is None:
            # one probe decode learns the item spec for the slabs
            probe = self.dataset[batches[0][0]]
            self._pool = _ProcessPool(self.dataset, self.batch_size,
                                      self.num_workers,
                                      n_slabs=self.prefetch + 2,
                                      probe_item=probe)
        pool = self._pool
        free = list(range(len(pool.slabs.slabs)))
        # slab_id -> [batch_pos, remaining, error]; batches completed out of
        # order wait for their turn (yield order == batch order)
        inflight = {}
        done = {}                 # batch_pos -> (slab_id, n_items, error)
        outstanding = 0           # dispatched item tasks not yet reported
        next_dispatch, next_yield = 0, 0
        try:
            while next_yield < len(batches):
                while free and next_dispatch < len(batches):
                    slab_id = free.pop()
                    ids = batches[next_dispatch]
                    inflight[slab_id] = [next_dispatch, len(ids), None]
                    for slot, index in enumerate(ids):
                        pool.task_q.put((slab_id, slot, index, self.epoch))
                        outstanding += 1
                    next_dispatch += 1
                slab_id, slot, err = pool.result_q.get()
                outstanding -= 1
                entry = inflight[slab_id]
                entry[1] -= 1
                if err is not None and entry[2] is None:
                    entry[2] = err
                if entry[1] == 0:
                    done[entry[0]] = (slab_id, len(batches[entry[0]]),
                                      entry[2])
                    del inflight[slab_id]
                while next_yield in done:
                    slab_id, n, err = done.pop(next_yield)
                    if err is not None:
                        free.append(slab_id)
                        raise RuntimeError(f"data worker failed: {err}")
                    batch = _empty_batch(pool.spec, n)
                    for k, t in batch.items():
                        t.copy_(torch.from_numpy(
                            pool.slabs.slabs[slab_id][k][:n]))
                    free.append(slab_id)
                    self._cursor += 1
                    next_yield += 1
                    yield batch
            self.epoch += 1
            self._cursor = 0
        finally:
            # early exit or error: withdraw the tasks no worker has taken,
            # then drain the results of those in flight so that the queues
            # are clean for the next __iter__; rebuild the pool on timeout
            while outstanding > 0:
                try:
                    pool.task_q.get_nowait()
                    outstanding -= 1
                except queue.Empty:
                    break
            deadline = time.monotonic() + 60.0
            while outstanding > 0 and time.monotonic() < deadline:
                try:
                    pool.result_q.get(timeout=1.0)
                    outstanding -= 1
                except queue.Empty:
                    continue
            if outstanding > 0:
                self.close()

    def __iter__(self) -> Iterator[dict]:
        if self.worker_mode == "process":
            yield from self._iter_process()
            return
        batches = self._epoch_batches()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a producer blocked on a full queue must still see an early
            # consumer exit, or it keeps its thread pool and batches
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_ids in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_ids))
                        if not put(_collate(items)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(None)  # no-op if the consumer already stopped

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                self._cursor += 1
                yield item
            # epoch fully drained -> next __iter__ starts the next epoch
            self.epoch += 1
            self._cursor = 0
        finally:
            stop.set()
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30.0)
