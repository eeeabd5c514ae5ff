"""The receive kernel wrapper's read-back cache (`_read_back`): one
computation for the same live tensors, a new one after an in-place change,
for other tensors or another pattern of None, and no entry kept for a
tensor that died."""

import gc

import torch

from beifong_tpu_torch.integrators import receive_kernel as rk


def _counting():
    calls = []

    def fn(*tensors):
        calls.append(tensors)
        return sum(0 if t is None else float(t.sum()) for t in tensors)
    return fn, calls


def test_read_back_computes_once_for_the_same_tensors():
    fn, calls = _counting()
    a, b = torch.ones(3), torch.full((2,), 2.0)
    assert rk._read_back('t1', (a, b), fn) == 7.0
    assert rk._read_back('t1', (a, b), fn) == 7.0
    assert len(calls) == 1
    # another key, or the tensors in another order, computes anew
    assert rk._read_back('t2', (a, b), fn) == 7.0
    assert rk._read_back('t1', (b, a), fn) == 7.0
    assert len(calls) == 3


def test_read_back_follows_in_place_changes_and_none():
    fn, calls = _counting()
    a = torch.ones(3)
    assert rk._read_back('t3', (a, None), fn) == 3.0
    a.add_(1.0)
    assert rk._read_back('t3', (a, None), fn) == 6.0
    assert rk._read_back('t3', (a, None), fn) == 6.0
    assert len(calls) == 2
    b = torch.ones(1)
    assert rk._read_back('t3', (a, b), fn) == 7.0
    assert len(calls) == 3


def test_read_back_forgets_dead_tensors():
    def fn(t):   # keeps no reference to the tensor
        return 1.0
    a, c = torch.ones(4), torch.zeros(1)
    rk._read_back('t4', (a,), fn)
    key = ('t4', id(a))
    assert key in rk._READ_BACK
    del a
    gc.collect()
    rk._read_back('t4', (c,), fn)   # a miss sweeps the dead
    assert key not in rk._READ_BACK
