"""RandomManager — deterministic-when-testing RNG handout.

Counterpart of ``oryx_tpu/common/rand.py`` (reference: RandomManager.java
:35-52).  NumPy generators only: the same test seed gives the same
stream as the reference package, so the LSH hyperplanes drawn from it
are identical.  Torch code never draws from the global torch RNG
state.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

__all__ = ["RandomManager"]

_TEST_SEED = 1234567890123456789 & 0xFFFFFFFF


class RandomManager:
    _lock = threading.Lock()
    _use_test_seed = False
    # bounded strong refs: only needed so use_test_seed() can retroactively
    # re-seed generators already handed out, as the reference does
    _instances: "collections.deque[np.random.Generator]" = \
        collections.deque(maxlen=1024)

    @classmethod
    def random(cls) -> np.random.Generator:
        """A new numpy Generator; seeded deterministically in test mode."""
        with cls._lock:
            if cls._use_test_seed:
                gen = np.random.Generator(np.random.PCG64(_TEST_SEED))
            else:
                gen = np.random.Generator(np.random.PCG64())
            cls._instances.append(gen)
            return gen

    @classmethod
    def random_seed(cls) -> int:
        """A seed for APIs that take an integer: the test seed in test
        mode, else fresh entropy (the reference's stream, so a seeded
        trainer draws the same initial factors)."""
        with cls._lock:
            if cls._use_test_seed:
                return _TEST_SEED
            return int(np.random.SeedSequence().entropy) & 0x7FFFFFFFFFFFFFFF

    @classmethod
    def use_test_seed(cls) -> None:
        """Switch to fixed-seed mode and retroactively reset generators
        already handed out."""
        with cls._lock:
            cls._use_test_seed = True
            for gen in list(cls._instances):
                gen.bit_generator.state = np.random.PCG64(_TEST_SEED).state
