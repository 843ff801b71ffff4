"""The bounded first-in, first-out cache helper (``utils/cache.py``) that
the port's plan, pack, factor-scale and solver caches share."""
from pysolvers_tpu_torch.utils.cache import fifo_put


def test_fifo_put_drops_the_oldest_first():
    cache = {}
    for k in range(5):
        assert fifo_put(cache, k, str(k), 3) == str(k)
    assert list(cache.items()) == [(2, "2"), (3, "3"), (4, "4")]
    cache.pop(3)                    # a caller may drop an entry itself
    fifo_put(cache, 5, "5", 3)
    assert list(cache) == [2, 4, 5]
    fifo_put(cache, 6, "6", 3)
    assert list(cache) == [4, 5, 6]
