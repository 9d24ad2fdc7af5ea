"""LRC (locally repairable / layered) erasure-code plugin.

Counterpart of the JAX package's ``lrc`` plugin (ceph_tpu/ec/plugins/
lrc.py).  Every layer's inner plugin is built through the port's
registry on the LRC code's own device.  Behavioral twin of the
reference LRC plugin (src/erasure-code/lrc/ErasureCodeLrc.{h,cc},
ErasureCodePluginLrc.cc):
a stack of layers, each an inner erasure code (jerasure reed_sol_van by
default) applied to the subset of chunk positions its ``chunks_map``
string marks 'D' (data) / 'c' (coding); '_' positions are ignored by
that layer.  Configuration is either

- explicit: ``mapping`` (global 'D'/'_' string) + ``layers`` (JSON array
  of [chunks_map, inner-profile] entries, bottom layer first), optionally
  ``crush-steps`` (JSON [[op, type, n], ...]); or
- generated from ``k``/``m``/``l`` (parse_kml, ErasureCodeLrc.cc:719-791):
  one global layer plus (k+m)/l local layers of l data + 1 local parity,
  with crush steps [choose <crush-locality> groups, chooseleaf
  <failure-domain> l+1].

Decode walks the layers *top down* (reverse vector order), fixing each
layer's erasures with the inner code when they fit within its parity
count, feeding recovered chunks to the layers above
(ErasureCodeLrc.cc:747-838); minimum_to_decode prefers the smallest
covering layer so a single lost chunk reads only its local group
(ErasureCodeLrc.cc:565-676 cases 1-3).
"""

from __future__ import annotations

import errno
import json

import numpy as np

from ceph_tpu_torch.ec.interface import ECError, ErasureCode
from ceph_tpu_torch.ops.rs_kernels import resolve_device

__erasure_code_version__ = "0.1.0"

DEFAULT_KML = "-1"


class Step:
    """One CRUSH rule step: op ('choose'|'chooseleaf'), bucket type, n
    (reference ErasureCodeLrc.h Step)."""

    def __init__(self, op: str, type_: str, n: int):
        self.op = op
        self.type = type_
        self.n = n


class Layer:
    """One code layer (reference ErasureCodeLrc.h Layer)."""

    def __init__(self, chunks_map: str):
        self.chunks_map = chunks_map
        self.erasure_code: ErasureCode | None = None
        self.data: list[int] = []
        self.coding: list[int] = []
        self.chunks: list[int] = []
        self.chunks_as_set: set[int] = set()
        self.profile: dict = {}


class ErasureCodeLrc(ErasureCode):
    def __init__(self, directory: str | None = None, *, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        from ceph_tpu_torch.ec.registry import DEFAULT_PLUGIN_DIRECTORY

        self.directory = directory or DEFAULT_PLUGIN_DIRECTORY
        self.layers: list[Layer] = []
        self._chunk_count = 0
        self._data_chunk_count = 0
        self.rule_root = "default"
        self.rule_device_class = ""
        self.rule_steps = [Step("chooseleaf", "host", 0)]

    # -- interface geometry --------------------------------------------------

    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self._data_chunk_count

    def get_chunk_size(self, object_size: int) -> int:
        # delegate to the bottom (global) layer (ErasureCodeLrc.cc:557)
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- init pipeline (ErasureCodeLrc.cc:492-541) ---------------------------

    def init(self, profile: dict, quiet: bool = False) -> None:
        self.parse_kml(profile)
        self._parse_rule(profile)
        description = self.layers_description(profile)
        self.layers_parse(description)
        self.layers_init()
        if "mapping" not in profile:
            raise ECError(errno.EINVAL, "the 'mapping' profile is missing")
        mapping = profile["mapping"]
        self._data_chunk_count = mapping.count("D")
        self._chunk_count = len(mapping)
        # derive the data-first chunk remap now: the reference parses
        # 'mapping' (ErasureCodeLrc::parse -> to_mapping) before the
        # kml-generated key is erased below
        self._to_mapping({"mapping": mapping})
        self.layers_sanity_checks()
        # kml-generated parameters are internal; do not expose them in
        # the stored profile (ErasureCodeLrc.cc:531-539)
        if profile.get("l", DEFAULT_KML) != DEFAULT_KML:
            profile.pop("mapping", None)
            profile.pop("layers", None)
        super().init(profile, quiet)

    # -- kml shorthand (ErasureCodeLrc.cc:719-791) ---------------------------

    def parse_kml(self, profile: dict) -> None:
        k = self.to_int("k", profile, DEFAULT_KML)
        m = self.to_int("m", profile, DEFAULT_KML)
        l = self.to_int("l", profile, DEFAULT_KML)
        if (k, m, l) == (-1, -1, -1):
            return
        if -1 in (k, m, l):
            raise ECError(
                errno.EINVAL, "all of k, m, l must be set or none of them"
            )
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ECError(
                    errno.EINVAL,
                    f"the {generated} parameter cannot be set when k, m, l are set",
                )
        if l == 0 or (k + m) % l:
            raise ECError(errno.EINVAL, "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ECError(errno.EINVAL, "k must be a multiple of (k + m) / l")
        if m % groups:
            raise ECError(errno.EINVAL, "m must be a multiple of (k + m) / l")

        mapping = ("D" * (k // groups) + "_" * (m // groups) + "_") * groups
        profile["mapping"] = mapping

        layers = []
        # global layer
        layers.append([
            ("D" * (k // groups) + "c" * (m // groups) + "_") * groups, ""
        ])
        # local layers: one extra parity over each group of l data
        for i in range(groups):
            row = ""
            for j in range(groups):
                row += "D" * l + "c" if i == j else "_" * (l + 1)
            layers.append([row, ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host") or "host"
        if locality:
            self.rule_steps = [
                Step("choose", locality, groups),
                Step("chooseleaf", failure_domain, l + 1),
            ]
        elif failure_domain:
            self.rule_steps = [Step("chooseleaf", failure_domain, 0)]

    # -- rule config (ErasureCodeLrc.cc:398-489) -----------------------------

    def _parse_rule(self, profile: dict) -> None:
        self.rule_root = self.to_string("crush-root", profile, "default")
        self.rule_device_class = profile.get("crush-device-class", "")
        if "crush-steps" in profile:
            try:
                steps = json.loads(profile["crush-steps"])
            except json.JSONDecodeError as e:
                raise ECError(
                    errno.EINVAL, f"failed to parse crush-steps: {e}"
                ) from None
            if not isinstance(steps, list):
                raise ECError(errno.EINVAL, "crush-steps must be a JSON array")
            self.rule_steps = []
            for entry in steps:
                if (
                    not isinstance(entry, list)
                    or len(entry) != 3
                    or not isinstance(entry[0], str)
                    or not isinstance(entry[1], str)
                    or not isinstance(entry[2], int)
                ):
                    raise ECError(
                        errno.EINVAL,
                        f"crush-steps element {entry!r} must be [op, type, n]",
                    )
                self.rule_steps.append(Step(entry[0], entry[1], entry[2]))

    def create_rule(self, name: str, crush_map) -> int:
        """Per-layer CRUSH steps: set tries, take root, then each
        configured choose/chooseleaf indep step (ErasureCodeLrc.cc:44-110)."""
        from ceph_tpu_torch.crush.types import Rule, RuleOp, RuleStep

        if name in crush_map.rule_names:
            raise ECError(errno.EEXIST, f"rule {name} exists")
        if self.rule_root not in crush_map.bucket_names:
            raise ECError(
                errno.ENOENT, f"root item {self.rule_root} does not exist"
            )
        root_id = crush_map.bucket_names[self.rule_root]
        steps = [
            RuleStep(RuleOp.SET_CHOOSELEAF_TRIES, 5, 0),
            RuleStep(RuleOp.SET_CHOOSE_TRIES, 100, 0),
            RuleStep(RuleOp.TAKE, root_id, 0),
        ]
        for s in self.rule_steps:
            try:
                type_id = crush_map.type_id(s.type)
            except KeyError:
                raise ECError(errno.EINVAL, f"unknown crush type {s.type}") from None
            op = (
                RuleOp.CHOOSELEAF_INDEP if s.op == "chooseleaf" else RuleOp.CHOOSE_INDEP
            )
            steps.append(RuleStep(op, s.n, type_id))
        steps.append(RuleStep(RuleOp.EMIT, 0, 0))
        rid = max(crush_map.rules.keys(), default=-1) + 1
        crush_map.rules[rid] = Rule(
            rule_type=3, steps=steps,
            device_class=self.rule_device_class or None,
        )
        crush_map.rule_names[name] = rid
        return rid

    # -- layers (ErasureCodeLrc.cc:112-263) ----------------------------------

    def layers_description(self, profile: dict) -> list:
        if "layers" not in profile:
            raise ECError(errno.EINVAL, "could not find 'layers' in profile")
        try:
            description = json.loads(profile["layers"])
        except json.JSONDecodeError as e:
            raise ECError(
                errno.EINVAL, f"failed to parse layers='{profile['layers']}': {e}"
            ) from None
        if not isinstance(description, list):
            raise ECError(errno.EINVAL, "layers must be a JSON array")
        return description

    def layers_parse(self, description: list) -> None:
        self.layers = []
        for position, entry in enumerate(description):
            if not isinstance(entry, list):
                raise ECError(
                    errno.EINVAL,
                    f"each element of layers must be a JSON array "
                    f"(position {position})",
                )
            layer = Layer(str(entry[0]) if entry else "")
            if not entry or not isinstance(entry[0], str):
                raise ECError(
                    errno.EINVAL,
                    f"the first element of the entry at position {position} "
                    "must be a string",
                )
            if len(entry) > 1:
                cfg = entry[1]
                if isinstance(cfg, str):
                    # "k=2 m=1 plugin=jerasure" style pair list
                    for pair in cfg.split():
                        if "=" in pair:
                            key, value = pair.split("=", 1)
                            layer.profile[key] = value
                elif isinstance(cfg, dict):
                    layer.profile = {k: str(v) for k, v in cfg.items()}
                else:
                    raise ECError(
                        errno.EINVAL,
                        f"the second element of the entry at position "
                        f"{position} must be a string or object",
                    )
            self.layers.append(layer)

    def layers_init(self) -> None:
        from ceph_tpu_torch.ec import registry
        for layer in self.layers:
            for position, ch in enumerate(layer.chunks_map):
                if ch == "D":
                    layer.data.append(position)
                if ch == "c":
                    layer.coding.append(position)
                if ch in ("c", "D"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", "jerasure")
            layer.profile.setdefault("technique", "reed_sol_van")
            layer.erasure_code = registry.factory(
                layer.profile["plugin"], layer.profile, self.directory,
                device=self.device,
            )

    def layers_sanity_checks(self) -> None:
        if len(self.layers) < 1:
            raise ECError(
                errno.EINVAL,
                "layers parameter must have at least one entry",
            )
        for layer in self.layers:
            if self._chunk_count != len(layer.chunks_map):
                raise ECError(
                    errno.EINVAL,
                    f"layer '{layer.chunks_map}' is expected to be "
                    f"{self._chunk_count} characters long but is "
                    f"{len(layer.chunks_map)} characters long instead",
                )

    # -- minimum_to_decode (ErasureCodeLrc.cc:565-676) -----------------------

    def _minimum_to_decode(self, want_to_read, available_chunks):
        n = self.get_chunk_count()
        erasures_total = {i for i in range(n) if i not in available_chunks}
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & set(want_to_read)

        # case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # case 2: recover wanted erasures with as few chunks as possible,
        # preferring upper (smaller, local) layers
        minimum: set[int] = set()
        for layer in reversed(self.layers):
            layer_want = set(want_to_read) & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                    # too many erasures for this layer; hope above
                    continue
                layer_minimum = layer.chunks_as_set - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= set(want_to_read)
            minimum -= erasures_total
            return minimum

        # case 3: cascade recoveries through layers that do not contain
        # wanted chunks, in the hope they unblock upper layers
        erasures_total = {i for i in range(n) if i not in available_chunks}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available_chunks)

        raise ECError(
            errno.EIO,
            f"not enough chunks in {sorted(available_chunks)} to read "
            f"{sorted(want_to_read)}",
        )

    # -- encode/decode (ErasureCodeLrc.cc:678-859) ---------------------------

    def encode_chunks(self, want_to_encode, encoded) -> None:
        # find the deepest layer that covers everything wanted; encode
        # it and every layer above
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if set(want_to_encode) <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_encoded = {
                j: encoded[c] for j, c in enumerate(layer.chunks)
            }
            layer_want = {
                j for j, c in enumerate(layer.chunks) if c in want_to_encode
            }
            # layer_encoded aliases encoded's buffers, so the inner
            # plugin's in-place writes land directly in encoded
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        n = self.get_chunk_count()
        available_chunks = {i for i in range(n) if i in chunks}
        erasures = {i for i in range(n) if i not in chunks}
        # start from the wanted erasures (not the empty set): if every
        # layer is overwhelmed and skips, we must report EIO rather than
        # hand back zero-filled placeholders (the reference leaves this
        # to the minimum_to_decode caller; decoding directly must not
        # silently corrupt)
        want_to_read_erasures: set[int] = erasures & set(want_to_read)

        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > layer.erasure_code.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue  # all available
            # pick payloads from *decoded* so chunks recovered by
            # previous (upper) layers are reused
            layer_chunks = {
                j: decoded[c]
                for j, c in enumerate(layer.chunks)
                if c not in erasures
            }
            layer_decoded = {j: decoded[c] for j, c in enumerate(layer.chunks)}
            layer_want = {
                j for j, c in enumerate(layer.chunks) if c in want_to_read
            }
            # layer_decoded aliases decoded's buffers: recovered chunks
            # land in place, ready for deeper layers to reuse
            layer.erasure_code.decode_chunks(
                layer_want, layer_chunks, layer_decoded
            )
            for c in layer.chunks:
                erasures.discard(c)
            want_to_read_erasures = erasures & set(want_to_read)
            if not want_to_read_erasures:
                break

        if want_to_read_erasures:
            raise ECError(
                errno.EIO,
                f"want to read {sorted(want_to_read)} with available "
                f"{sorted(available_chunks)} ends up unable to read "
                f"{sorted(want_to_read_erasures)}",
            )


def __erasure_code_init__(name: str, registry) -> None:
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin

    class LrcPlugin(ErasureCodePlugin):
        def factory(self, profile: dict, *, device=None):
            ec = ErasureCodeLrc(device=device)
            ec.init(profile)
            return ec

    registry.add(name, LrcPlugin())
