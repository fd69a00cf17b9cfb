"""The arithmetic a cell's bound is set from: A/A runs of one tree, two sets
of runs on one card with the same seeds, and the split of their spread into
what lies between runs and what drifts within one.

A quartile spread is (Q3 - Q1) / median with Python's
`statistics.quantiles(values, n=4)` (numpy's quartiles lie closer
together); a range is (max - min) / median. The bound's rule
(`bound_from_sets`) is the larger of five times the wider quartile spread
of the two sets and twice the range of all their runs, clamped to 1%-25%
and rounded up to a tenth of a per cent."""

from __future__ import annotations

import math
import statistics

BOUND_MIN, BOUND_MAX = 0.01, 0.25


def quartile_spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def relative_range(values) -> float:
    return (max(values) - min(values)) / statistics.median(values)


def bound_from_sets(set_a, set_b) -> float:
    """The bound of an end-to-end metric from two A/A sets of its runs."""
    by_quartiles = 5 * max(quartile_spread(set_a), quartile_spread(set_b))
    by_range = 2 * relative_range(list(set_a) + list(set_b))
    raw = min(max(by_quartiles, by_range, BOUND_MIN), BOUND_MAX)
    return math.ceil(round(raw * 1000, 6)) / 1000


def unit_seconds(ends) -> list:
    """Each unit's seconds from the window's ends (seconds since it
    opened, one at the end of each unit)."""
    return [b - a for a, b in zip([0.0] + list(ends[:-1]), ends)]


def spread_split(runs) -> dict:
    """What the spread of a rate over runs is made of, from each run's
    units' seconds (`unit_s`; the first unit, which also records what the
    reference follows, is left out).

    between: the quartile spread, over runs, of each run's median unit.
    within: the median over runs of the quartile spread of its own units.
    drift: the median over runs of (median of the second half of its units
    - median of the first half) / its median unit.
    within_of_a_run: what the within-run part alone leaves in a run's mean
    unit, the within spread over the square root of the units a run has.
    """
    medians, within, drift, counts = [], [], [], []
    for run in runs:
        units = run["unit_s"][1:]
        if len(units) < 4:
            raise ValueError("a run needs four units past its first")
        med = statistics.median(units)
        half = len(units) // 2
        medians.append(med)
        within.append(quartile_spread(units))
        drift.append((statistics.median(units[-half:])
                      - statistics.median(units[:half])) / med)
        counts.append(len(units))
    w = statistics.median(within)
    return {"between": quartile_spread(medians), "within": w,
            "drift": statistics.median(drift),
            "within_of_a_run": w / math.sqrt(statistics.median(counts))}
