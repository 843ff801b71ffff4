"""Bounded first-in, first-out caches: plain dicts that drop their oldest
entry to make room for a new one."""


def fifo_put(cache: dict, key, value, size: int):
    """Store ``value`` under ``key`` in ``cache`` and return it, first
    dropping the oldest entries so that ``cache`` holds at most ``size``."""
    while len(cache) >= size:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value
