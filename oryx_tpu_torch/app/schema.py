"""Input schema: the configuration's typing of the input features.

Counterpart of ``oryx_tpu/app/schema.py`` (reference:
InputSchema.java:37-282 — feature names and count, id and ignored
features, numeric against categorical, the target, and the
feature <-> predictor index maps; CategoricalValueEncodings.java:32 —
the category value <-> dense index dictionaries).
"""

from __future__ import annotations

from typing import Iterable, Mapping

from ..common.config import Config

__all__ = ["InputSchema", "CategoricalValueEncodings"]


class InputSchema:
    """Feature typing for the apps that need a schema (k-means, RDF)."""

    def __init__(self, config: Config):
        given_names = config.get_string_list("oryx.input-schema.feature-names")
        if not given_names:
            num = config.get_int("oryx.input-schema.num-features")
            if num <= 0:
                raise ValueError(
                    "Neither feature-names nor num-features is set")
            given_names = [str(i) for i in range(num)]
        if len(set(given_names)) != len(given_names):
            raise ValueError(f"Feature names must be unique: {given_names}")
        self.feature_names: list[str] = list(given_names)

        self.id_features = frozenset(
            config.get_string_list("oryx.input-schema.id-features"))
        ignored = frozenset(
            config.get_string_list("oryx.input-schema.ignored-features"))
        for named in (self.id_features, ignored):
            missing = named - set(self.feature_names)
            if missing:
                raise ValueError(f"Unknown features: {sorted(missing)}")

        active = set(self.feature_names) - self.id_features - ignored
        self.active_features = frozenset(active)

        numeric = config.get_optional_string_list(
            "oryx.input-schema.numeric-features")
        categorical = config.get_optional_string_list(
            "oryx.input-schema.categorical-features")
        if numeric is None:
            if categorical is None:
                raise ValueError(
                    "Neither numeric-features nor categorical-features set")
            self.categorical_features = frozenset(categorical)
            if not self.categorical_features <= self.active_features:
                raise ValueError("categorical-features must be active")
            self.numeric_features = frozenset(
                active - self.categorical_features)
        else:
            self.numeric_features = frozenset(numeric)
            if not self.numeric_features <= self.active_features:
                raise ValueError("numeric-features must be active")
            self.categorical_features = frozenset(
                active - self.numeric_features)

        self.target_feature = config.get_optional_string(
            "oryx.input-schema.target-feature")
        if self.target_feature is not None and \
                self.target_feature not in self.active_features:
            raise ValueError(
                f"Target feature is not known, an ID, or ignored: "
                f"{self.target_feature}")
        self.target_feature_index = (
            -1 if self.target_feature is None
            else self.feature_names.index(self.target_feature))

        # all-feature index <-> predictor-only index
        self._feature_to_predictor: dict[int, int] = {}
        self._predictor_to_feature: dict[int, int] = {}
        p = 0
        for f in range(len(self.feature_names)):
            if self.is_active(f) and not self.is_target(f):
                self._feature_to_predictor[f] = p
                self._predictor_to_feature[p] = f
                p += 1

    def _name(self, feature: int | str) -> str:
        return self.feature_names[feature] if isinstance(feature, int) \
            else feature

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_predictors(self) -> int:
        return len(self._feature_to_predictor)

    def is_id(self, feature: int | str) -> bool:
        return self._name(feature) in self.id_features

    def is_active(self, feature: int | str) -> bool:
        return self._name(feature) in self.active_features

    def is_numeric(self, feature: int | str) -> bool:
        return self._name(feature) in self.numeric_features

    def is_categorical(self, feature: int | str) -> bool:
        return self._name(feature) in self.categorical_features

    def is_target(self, feature: int | str) -> bool:
        if isinstance(feature, int):
            return feature == self.target_feature_index
        return feature == self.target_feature

    def has_target(self) -> bool:
        return self.target_feature is not None

    def is_classification(self) -> bool:
        """Whether the target is categorical (reference:
        InputSchema.isClassification)."""
        return self.has_target() and self.is_categorical(self.target_feature)

    def feature_to_predictor_index(self, feature_index: int) -> int:
        return self._feature_to_predictor[feature_index]

    def predictor_to_feature_index(self, predictor_index: int) -> int:
        return self._predictor_to_feature[predictor_index]

    def __repr__(self):  # pragma: no cover
        return f"InputSchema[featureNames:{self.feature_names}]"


class CategoricalValueEncodings:
    """Per-feature dictionaries mapping category value <-> dense index
    (reference: CategoricalValueEncodings.java:32).  Input is a map of
    feature index to the feature's distinct values, encoded in order."""

    def __init__(self, distinct_values: Mapping[int, Iterable[str]]):
        self._encodings: dict[int, dict[str, int]] = {}
        self._decodings: dict[int, dict[int, str]] = {}
        for feature, values in distinct_values.items():
            enc: dict[str, int] = {}
            for v in values:
                if v not in enc:
                    enc[v] = len(enc)
            self._encodings[feature] = enc
            self._decodings[feature] = {i: v for v, i in enc.items()}

    def get_value_count(self, feature_index: int) -> int:
        return len(self._encodings[feature_index])

    def get_value_encoding_map(self, feature_index: int) -> dict[str, int]:
        return dict(self._encodings[feature_index])

    def get_encoding_value_map(self, feature_index: int) -> dict[int, str]:
        return dict(self._decodings[feature_index])

    def get_category_counts(self) -> dict[int, int]:
        return {f: len(m) for f, m in self._encodings.items()}

    def encode(self, feature_index: int, value: str) -> int:
        return self._encodings[feature_index][value]

    def try_encode(self, feature_index: int, value: str) -> int | None:
        """Encoding, or None for a value (or feature) with no
        dictionary entry."""
        return self._encodings.get(feature_index, {}).get(value)

    def decode(self, feature_index: int, encoding: int) -> str:
        return self._decodings[feature_index][encoding]

    def __repr__(self):  # pragma: no cover
        return f"CategoricalValueEncodings[{self.get_category_counts()}]"
