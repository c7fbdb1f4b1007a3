"""Hyperparameter value ranges and grid-search combination chooser.

Counterpart of ``oryx_tpu/ml/params.py``, whole.  The combinations are
drawn from this package's ``RandomManager``, whose NumPy streams are
the reference's, so one seed chooses the same combinations in both.

Reference: framework/oryx-ml/src/main/java/com/cloudera/oryx/ml/param/
HyperParams.java (fromConfig :74, chooseHyperParameterCombos :123,
chooseValuesPerHyperParam :180), ContinuousRange.java:64,
DiscreteRange.java:72, ContinuousAround.java, DiscreteAround.java,
Unordered.java:47, HyperParamValues.java:35.
"""

from __future__ import annotations

import abc
from typing import Sequence

from ..common.config import Config
from ..common.rand import RandomManager

__all__ = [
    "HyperParamValues", "fixed", "range_values", "around", "unordered",
    "from_config", "choose_hyper_parameter_combos", "choose_values_per_hyperparam",
]

_MAX_COMBOS = 65536


class HyperParamValues(abc.ABC):
    """A range of values of one hyperparameter to try."""

    @abc.abstractmethod
    def get_trial_values(self, num: int) -> list:
        """``num`` representative values spanning the range."""


class _Fixed(HyperParamValues):
    def __init__(self, value):
        self._value = value

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        return [self._value]

    def __repr__(self):  # pragma: no cover
        return f"Fixed[{self._value}]"


class _ContinuousRange(HyperParamValues):
    def __init__(self, lo: float, hi: float):
        if lo > hi:
            raise ValueError("min > max")
        self._lo, self._hi = lo, hi

    def get_trial_values(self, num: int) -> list[float]:
        assert num > 0
        lo, hi = self._lo, self._hi
        if hi == lo:
            return [lo]
        if num == 1:
            return [(lo + hi) / 2.0]
        step = (hi - lo) / (num - 1)
        vals = [lo + i * step for i in range(num - 1)]
        vals.append(hi)
        return vals


class _DiscreteRange(HyperParamValues):
    def __init__(self, lo: int, hi: int):
        if lo > hi:
            raise ValueError("min > max")
        self._lo, self._hi = lo, hi

    def get_trial_values(self, num: int) -> list[int]:
        assert num > 0
        lo, hi = self._lo, self._hi
        if hi == lo:
            return [lo]
        if num == 1:
            return [(lo + hi) // 2]
        if num == 2:
            return [lo, hi]
        if num > hi - lo:
            return list(range(lo, hi + 1))
        step = (hi - lo) / (num - 1)
        vals: list[int] = [lo]
        for _ in range(num - 2):
            vals.append(int(round(vals[-1] + step)))
        vals.append(hi)
        return vals


class _ContinuousAround(HyperParamValues):
    def __init__(self, around_val: float, step: float):
        if step <= 0:
            raise ValueError("step must be positive")
        self._around, self._step = around_val, step

    def get_trial_values(self, num: int) -> list[float]:
        assert num > 0
        if num == 1:
            return [self._around]
        start = self._around - ((num - 1) / 2.0) * self._step
        vals = [start + i * self._step for i in range(num)]
        if num % 2 != 0:
            vals[num // 2] = self._around  # keep middle value exact
        return vals


class _DiscreteAround(HyperParamValues):
    def __init__(self, around_val: int, step: int):
        if step <= 0:
            raise ValueError("step must be positive")
        self._around, self._step = around_val, step

    def get_trial_values(self, num: int) -> list[int]:
        assert num > 0
        if num == 1:
            return [self._around]
        start = self._around - ((num - 1) * self._step // 2)
        return [start + i * self._step for i in range(num)]


class _Unordered(HyperParamValues):
    def __init__(self, values: Sequence):
        if not values:
            raise ValueError("no values")
        self._values = list(values)

    def get_trial_values(self, num: int) -> list:
        assert num > 0
        return self._values[:num] if num < len(self._values) else list(self._values)


def fixed(value) -> HyperParamValues:
    return _Fixed(value)


def range_values(lo, hi) -> HyperParamValues:
    if isinstance(lo, int) and isinstance(hi, int):
        return _DiscreteRange(lo, hi)
    return _ContinuousRange(float(lo), float(hi))


def around(value, step) -> HyperParamValues:
    if isinstance(value, int) and isinstance(step, int):
        return _DiscreteAround(value, step)
    return _ContinuousAround(float(value), float(step))


def unordered(values: Sequence) -> HyperParamValues:
    return _Unordered(values)


def from_config(config: Config, key: str) -> HyperParamValues:
    """Interpret a config value as fixed / range / unordered
    (reference: HyperParams.fromConfig :74).  A two-element list of
    numbers is a range; any other list is unordered; a scalar is fixed
    (int preferred over double over string)."""
    v = config.get(key)
    if isinstance(v, list):
        if len(v) == 2:
            # only parse failures fall through to 'unordered'; a reversed
            # numeric range like [8, 2] is a config error and propagates
            try:
                lo, hi = int(str(v[0])), int(str(v[1]))
            except ValueError:
                try:
                    lo, hi = float(str(v[0])), float(str(v[1]))
                except ValueError:
                    return unordered(list(v))
            return range_values(lo, hi)
        # unordered values keep their native types (ints stay ints)
        return unordered(list(v))
    s = str(v)
    try:
        return fixed(int(s))
    except ValueError:
        pass
    try:
        return fixed(float(s))
    except ValueError:
        pass
    return unordered([s])


def choose_values_per_hyperparam(num_params: int, candidates: int) -> int:
    """Smallest v with v^num_params >= candidates
    (reference: HyperParams.chooseValuesPerHyperParam :180)."""
    if num_params < 1:
        return 0
    v = 0
    total = 0
    while total < candidates:
        v += 1
        total = v ** num_params
    return v


def choose_hyper_parameter_combos(ranges: Sequence[HyperParamValues],
                                  how_many: int,
                                  per_param: int) -> list[list]:
    """Cartesian grid of trial values, randomly subsampled/shuffled to at
    most ``how_many`` combos (reference:
    HyperParams.chooseHyperParameterCombos :123)."""
    if how_many <= 0:
        raise ValueError("how_many must be positive")
    if per_param < 0:
        raise ValueError("per_param must be non-negative")
    num_params = len(ranges)
    if num_params == 0 or per_param == 0:
        return [[]]
    if per_param ** num_params > _MAX_COMBOS:
        raise ValueError(f"too many combinations: {per_param}^{num_params}")

    param_ranges = [r.get_trial_values(per_param) for r in ranges]
    total = 1
    for vals in param_ranges:
        total *= len(vals)

    combos: list[list] = []
    for combo in range(total):
        combination = []
        idx = combo
        for vals in param_ranges:
            combination.append(vals[idx % len(vals)])
            idx //= len(vals)
        combos.append(combination)

    rng = RandomManager.random()
    if how_many >= total:
        rng.shuffle(combos)
        return combos
    chosen = rng.permutation(total)[:how_many]
    result = [combos[i] for i in chosen]
    rng.shuffle(result)
    return result
