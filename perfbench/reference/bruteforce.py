"""The plain reference of the hybrid query: a brute force over the raw
table the benchmark made, in logical row ids, and the judge that holds
an answer to it. Plain NumPy; imports nothing of the program.

A query here is a conjunction: numeric ranges ``nr`` [(attr, lo, hi)],
an optional vector range ``vr`` (a radius) and an optional V.K ``vk``
(k), all about one query vector ``vec``. Its answer, by MOAPI's
semantics: the rows that meet every predicate; with a V.K, the k nearest
of them (post-filter), or of the whole table when there is no
predicate. The distance is the system's exact law, ``sum((x - v)**2)``
over each row in fp32 (NumPy's pairwise sum of a contiguous row), and
V.R keeps ``d2 <= radius**2`` with the bound rounded to fp32."""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

BLOCK = 2048   # rows a temporary: a row's sum never depends on it


def sq_dists(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(N,) exact squared distances of every row of ``x`` to ``v``."""
    v = np.asarray(v, np.float32)
    out = np.empty(len(x), np.float32)
    for i in range(0, len(x), BLOCK):
        t = x[i:i + BLOCK] - v[None, :]
        t **= 2
        out[i:i + BLOCK] = t.sum(axis=1)
    return out


def predicate_mask(q: dict, d2: np.ndarray,
                   numeric: Dict[str, np.ndarray]) -> np.ndarray:
    mask = np.ones(len(d2), bool)
    for attr, lo, hi in q.get("nr", ()):
        a = numeric[attr]
        mask &= (a >= np.float32(lo)) & (a <= np.float32(hi))
    if q.get("vr") is not None:
        mask &= d2 <= np.float32(float(q["vr"]) ** 2)
    return mask


def has_predicate(q: dict) -> bool:
    return bool(q.get("nr")) or q.get("vr") is not None


def evaluate(q: dict, d2: np.ndarray,
             numeric: Dict[str, np.ndarray]) -> np.ndarray:
    """The answer to ``q`` given every row's distance ``d2``: a top-level
    V.K in distance order (equal distances by row id), else ascending row
    ids."""
    mask = predicate_mask(q, d2, numeric)
    cand = np.nonzero(mask)[0]
    if q.get("vk") is None:
        return cand
    k = min(int(q["vk"]), len(cand))
    best = cand[np.lexsort((cand, d2[cand]))[:k]]
    return best if not has_predicate(q) else np.sort(best)


def judge(q: dict, d2: np.ndarray, numeric: Dict[str, np.ndarray],
          got: np.ndarray, ordered: bool) -> Optional[str]:
    """None when ``got`` (logical row ids) is a right answer to ``q``,
    else what is wrong. Rows at exactly the k-th distance may stand for
    one another, and so may the order of exactly equal distances; with
    ``ordered`` the rows must come in distance order."""
    got = np.asarray(got, np.int64)
    if len(np.unique(got)) != len(got):
        return "a row repeats"
    if len(got) and (got.min() < 0 or got.max() >= len(d2)):
        return "a row id outside the table"
    mask = predicate_mask(q, d2, numeric)
    cand = np.nonzero(mask)[0]
    if q.get("vk") is None:
        return None if np.array_equal(np.sort(got), cand) else \
            f"{len(got)} rows, {len(cand)} meet the predicates " \
            f"({len(np.setdiff1d(cand, got))} missing)"
    k = min(int(q["vk"]), len(cand))
    if len(got) != k:
        return f"{len(got)} rows for {k}"
    if not mask[got].all():
        return "a row fails a predicate"
    if k == 0:
        return None
    kth = np.partition(d2[cand], k - 1)[k - 1]
    dg = d2[got]
    if (dg > kth).any():
        return "a row beyond the k-th distance"
    if int((d2[cand] < kth).sum()) != int((dg < kth).sum()):
        return "a row nearer than the k-th distance is missing"
    if ordered and (np.diff(dg) < 0).any():
        return "rows out of distance order"
    return None


def judge_all(table: np.ndarray, numeric: Dict[str, np.ndarray],
              queries: Sequence[dict], answers: Sequence[np.ndarray],
              ordered: Sequence[bool],
              threads: int = 8) -> List[Optional[str]]:
    """``judge`` of each answer, the distances computed in ``threads``
    threads (NumPy releases the interpreter lock in its loops)."""
    def one(i):
        d2 = sq_dists(table, queries[i]["vec"])
        return judge(queries[i], d2, numeric, answers[i], ordered[i])
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        return list(ex.map(one, range(len(queries))))


def report(verdicts: Sequence[Optional[str]], relabelled: int) -> None:
    """The judged sample and its first faults, on standard error."""
    bad = [(i, v) for i, v in enumerate(verdicts) if v is not None]
    print(f"judged {len(verdicts)} sampled answers: {len(bad)} wrong, "
          f"{relabelled} with rows that are not the raw rows they claim",
          file=sys.stderr)
    for i, v in bad[:5]:
        print(f"  answer {i}: {v}", file=sys.stderr)
