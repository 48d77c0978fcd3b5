"""Minimal, dependency-free GenBank flat-file parser (the port's own copy
of the JAX package's ``genome/genbank.py``).

The reference uses BioPython's ``SeqIO.read(path, "genbank")`` and consumes
exactly: ``record.seq`` (str), ``record.features`` filtered to
``type == "gene"``, ``feature.qualifiers.get("gene", [""])[0]``, and
``int(feature.location.start) / int(feature.location.end)``
(the upstream genome_minimizer_2 ``minimizer/minimizer_2.py:59-83``).
This parser produces those fields with BioPython-compatible semantics:

- sequence letters are upper-cased (BioPython normalizes GenBank ORIGIN
  blocks to upper case),
- locations are converted to 0-based half-open [start, end) where ``start``
  is the *minimum* coordinate over all parts of a compound location and
  ``end`` the maximum (BioPython's CompoundLocation.start/end),
- ``complement(...)``, ``join(...)``, ``order(...)`` and partial markers
  (``<``, ``>``) are handled; qualifiers may span continuation lines.

Features come out as parallel numpy arrays (names, starts, ends) — the
layout the vectorized minimizer consumes directly — rather than per-feature
objects.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Iterator, List

import numpy as np

_FEATURE_INDENT = 21  # column where qualifiers/continuations start
_INT_RE = re.compile(r"\d+")


@dataclasses.dataclass
class Feature:
    type: str
    start: int   # 0-based inclusive (min over compound parts)
    end: int     # 0-based exclusive (max over compound parts)
    strand: int  # +1 / -1
    qualifiers: dict

    def gene_name(self) -> str:
        """feature.qualifiers.get("gene", [""])[0] (minimizer_2.py:61)."""
        vals = self.qualifiers.get("gene")
        return vals[0] if vals else ""


@dataclasses.dataclass
class GenBankRecord:
    name: str
    seq: str
    features: List[Feature]

    def __len__(self) -> int:
        return len(self.seq)

    def gene_features(self) -> List[Feature]:
        return [f for f in self.features if f.type == "gene"]

    def gene_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(names, starts, ends) arrays over features of type 'gene' — the
        vectorized-minimizer layout."""
        genes = self.gene_features()
        names = np.array([f.gene_name() for f in genes], dtype=object)
        starts = np.array([f.start for f in genes], dtype=np.int64)
        ends = np.array([f.end for f in genes], dtype=np.int64)
        return names, starts, ends


def parse_location(loc: str) -> tuple[int, int, int]:
    """GenBank location string -> (start0, end0_exclusive, strand).

    Mirrors BioPython: start = min over parts - 1, end = max over parts.
    Handles nesting of complement()/join()/order(), ranges a..b, single
    positions, sites a^b, and partial markers <a / >b.
    """
    strand = -1 if "complement" in loc else 1
    ints = [int(m) for m in _INT_RE.findall(loc)]
    if not ints:
        raise ValueError(f"Unparseable location: {loc!r}")
    return min(ints) - 1, max(ints), strand


def _parse_qualifier_block(lines: List[str]) -> dict:
    """Parse qualifier continuation lines ('/key=\"value\"', possibly wrapped)."""
    quals: dict[str, list] = {}
    key, value, in_string = None, None, False

    def commit():
        nonlocal key, value
        if key is not None:
            quals.setdefault(key, []).append(value if value is not None else "")
        key, value = None, None

    for raw in lines:
        text = raw.strip()
        if text.startswith("/") and not in_string:
            commit()
            if "=" in text:
                key, val = text[1:].split("=", 1)
                if val.startswith('"'):
                    val = val[1:]
                    if val.endswith('"') and len(val) >= 1:
                        value = val[:-1]
                    else:
                        value, in_string = val, True
                else:
                    value = val
            else:
                key, value = text[1:], None
        elif in_string:
            # wrapped quoted value; GenBank joins wrapped lines with a space
            # except inside translations (not needed here — join with space)
            if text.endswith('"'):
                value = f"{value} {text[:-1]}" if value else text[:-1]
                in_string = False
            else:
                value = f"{value} {text}" if value else text
    commit()
    return quals


def _iter_feature_chunks(feature_lines: List[str]) -> Iterator[tuple[str, str, List[str]]]:
    """Yield (type, location_str, qualifier_lines) per feature."""
    current = None
    for line in feature_lines:
        if len(line) > 5 and line[5] != " " and line[:5].strip() == "":
            # new feature header: 5 spaces, key, location
            if current:
                yield current
            parts = line.split(None, 1)
            ftype = parts[0]
            loc = parts[1].strip() if len(parts) > 1 else ""
            current = (ftype, loc, [])
        elif current is not None:
            text = line.strip()
            if text.startswith("/"):
                current[2].append(line)
            elif current[2]:
                current[2].append(line)  # continuation of a qualifier value
            else:
                # continuation of a wrapped location
                current = (current[0], current[1] + text, current[2])
    if current:
        yield current


def parse_genbank(path: str | Path) -> GenBankRecord:
    """Parse a single-record GenBank file (SeqIO.read semantics: exactly one
    record expected)."""
    text = Path(path).read_text()
    lines = text.splitlines()

    name = ""
    feature_lines: List[str] = []
    seq_parts: List[str] = []
    section = None
    n_records = 0
    for line in lines:
        if line.startswith("LOCUS"):
            n_records += 1
            if n_records > 1:
                # SeqIO.read semantics: exactly one record
                raise ValueError("More than one record found in handle")
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            section = "header"
        elif line.startswith("FEATURES"):
            section = "features"
        elif line.startswith("ORIGIN"):
            section = "origin"
        elif line.startswith("//"):
            section = None
        elif section == "features":
            feature_lines.append(line)
        elif section == "origin":
            seq_parts.append(re.sub(r"[^A-Za-z]", "", line))

    features: List[Feature] = []
    for ftype, loc, qlines in _iter_feature_chunks(feature_lines):
        try:
            start, end, strand = parse_location(loc)
        except ValueError:
            continue
        features.append(
            Feature(type=ftype, start=start, end=end, strand=strand,
                    qualifiers=_parse_qualifier_block(qlines))
        )

    # BioPython normalizes GenBank sequence to upper case
    seq = "".join(seq_parts).upper()
    return GenBankRecord(name=name, seq=seq, features=features)
