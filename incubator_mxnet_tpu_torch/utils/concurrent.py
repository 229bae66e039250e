"""Shared concurrency helpers for producer/consumer pipelines (twin of
``incubator_mxnet_tpu/utils/concurrent.py``)."""
import collections

__all__ = ["bounded_window"]


def bounded_window(items, submit, max_inflight):
    """Yield submitted handles in order with at most ``max_inflight``
    outstanding.  The backpressure pattern shared by the DataLoader
    worker pool and the im2rec encoder: unconsumed results hold
    memory (or /dev/shm segments), so producers must not run a whole
    epoch ahead of the consumer (the reference bounds its queues the
    same way, ~2x the worker count)."""
    inflight = collections.deque()
    it = iter(items)
    exhausted = False
    while inflight or not exhausted:
        while not exhausted and len(inflight) < max_inflight:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            inflight.append(submit(item))
        if inflight:
            yield inflight.popleft()
