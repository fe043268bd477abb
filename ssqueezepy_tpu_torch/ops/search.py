# -*- coding: utf-8 -*-
"""Scalar function searches used by the scale engine (host numpy).

`find_maximum` locates the peak of a unimodal positive function by
scanning fixed-size windows until the window max stops increasing;
`find_first_occurrence` scans for the first input whose output hits a
target value. Both take |fn(x)|. Counterpart of
`ssqueezepy_tpu/ops/search.py`; they run once per plan, on the host.
"""
import numpy as np

__all__ = ['find_maximum', 'find_first_occurrence', 'min_neglect_idx']


def find_maximum(fn, step_size=1e-3, steps_per_search=1e4, step_start=0,
                 step_limit=1000, min_value=-1):
    """Peak (input, value) of a single-maximum function, |fn| taken."""
    steps_per_search = int(steps_per_search)
    window = steps_per_search * step_size
    best_val = min_value
    best_in = None

    idx = 0
    while True:
        lo = step_start + window * idx
        inputs = np.linspace(lo, lo + window, steps_per_search,
                             endpoint=False)
        outputs = np.abs(np.asarray(fn(inputs)))

        wmax = outputs.max()
        if wmax > best_val:
            best_val = wmax
            best_in = inputs[np.argmax(outputs)]
        elif wmax < best_val:
            break
        idx += 1
        if inputs.max() > step_limit:
            raise ValueError(
                "could not find function maximum with given "
                "(step_size, steps_per_search, step_start, step_limit, "
                "min_value)=({}, {}, {}, {}, {})".format(
                    step_size, steps_per_search, step_start, step_limit,
                    min_value))
    return best_in, best_val


def find_first_occurrence(fn, value, step_size=1e-3, steps_per_search=1e4,
                          step_start=0, step_limit=1000):
    """Earliest input with |fn(input)| == value (within grid resolution)."""
    steps_per_search = int(steps_per_search)
    window = steps_per_search * step_size

    limit_hit = False
    idx = 0
    while True:
        lo = step_start + window * idx
        inputs = np.linspace(lo, lo + window, steps_per_search,
                             endpoint=False)
        if inputs.max() > step_limit:
            limit_hit = True
            inputs = np.clip(inputs, None, step_limit)

        outputs = np.abs(np.asarray(fn(inputs)))
        mxdiff = np.abs(np.diff(outputs)).max()

        if np.any(np.abs(outputs - value) <= mxdiff):
            i = np.argmin(np.abs(outputs - value))
            return inputs[i], outputs[i]
        idx += 1
        if limit_hit:
            raise ValueError(
                "could not find input yielding fn output value={} with "
                "given (step_size, steps_per_search, step_start, "
                "step_limit)=({}, {}, {}, {})".format(
                    value, step_size, steps_per_search, step_start,
                    step_limit))


def min_neglect_idx(arr, th=1e-12):
    """First index where `arr` drops below `th`."""
    idxs = np.where(arr < th)[0]
    return int(idxs[0]) if len(idxs) else len(arr) - 1
