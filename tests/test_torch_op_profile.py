"""How ``chip_smoke.py`` counts the device ops of one kernel wrapper's call
(``TRAINBN_OPS``, ``WINDOW_OPS``, the ball group's and rows 13 and 15's), on
the CPU with made-up profiles.

- ``ops_between_marks``: the ops between the two runs of spin-kernel marks
  around the call, by device start time. A run holds while one of its
  spins was recorded. A record from the warm-up step that falls into the
  profiled step lies before the first run and is not counted; a profile
  that lost a whole run holds nothing (None).
- ``held_op_launches``: a profile without its marks is taken again, an op
  beyond the expected ones fails at once, and one of up to
  ``TRAINBN_OP_ATTEMPTS`` profiles must hold every expected op; an op a call
  may add (``may``) is held up to its count.
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
RED = "(anonymous namespace)::reduce_kernel(float const*, int, long"
BWD_X = [("(anonymous namespace)::weight_rows_kernel(float const*, int,", 1),
         ("Memset (Device)", 1), ("Memset (Device)", 1),
         ("Memset (Device)", 1),
         ("void (anonymous namespace)::bwd_x_kernel<4>((anonymous names", 1),
         (RED, 1)]
WANT = {"bwd_x": cs.TRAINBN_OPS["bwd_x"]}


def _events(names, t0=100.0):
    return [(name, t0 + 10.0 * i) for i, name in enumerate(names)]


def _call():
    return [name for name, _ in BWD_X]


def _counted(names):
    out = {}
    for name in names:
        out[name[:60]] = out.get(name[:60], 0) + 1
    return out


@pytest.mark.parametrize("before", [[], [RED], ["Memset (Device)", RED]],
                         ids=["clean", "warm_up_reduce", "warm_up_tail"])
def test_ops_between_the_marks_are_the_calls(before):
    # the warm-up step's last ops, recorded in the profiled step, lie
    # before the first mark
    got = cs.ops_between_marks(_events(before + [SPIN] + _call() + [SPIN]))
    assert got == _counted(_call())


def test_events_are_ordered_by_device_start():
    ev = _events([RED, SPIN] + _call() + [SPIN])
    got = cs.ops_between_marks(list(reversed(ev)))
    assert got == _counted(_call())


@pytest.mark.parametrize("names", [[], _call(), _call()[2:] + [SPIN],
                                   [SPIN] + _call(), [SPIN, SPIN, SPIN]],
                         ids=["empty", "no_marks", "first_dropped",
                              "last_dropped", "three_marks"])
def test_a_profile_without_both_marks_holds_nothing(names):
    assert cs.ops_between_marks(_events(names)) is None


@pytest.mark.parametrize("before,after", [(3, 3), (1, 3), (3, 1), (2, 2),
                                          (1, 1)],
                         ids=["whole_runs", "first_run_short",
                              "second_run_short", "both_short",
                              "one_spin_each"])
def test_a_run_of_marks_holds_while_one_of_its_spins_is_recorded(before,
                                                                 after):
    # op_profile puts OP_MARK_RUN spins on either side of the call; the
    # profiler may drop some of them
    names = [RED] + [SPIN] * before + _call() + [SPIN] * after
    assert cs.ops_between_marks(_events(names)) == _counted(_call())


@pytest.mark.parametrize("names", [
    [RED] + _call() + [SPIN] * 3,
    [SPIN] * 3 + _call(),
    [SPIN] * 6,
    [SPIN] * 3 + _call()[:2] + [SPIN] + _call()[2:] + [SPIN] * 3],
    ids=["first_run_dropped", "second_run_dropped", "call_dropped",
         "three_runs"])
def test_spins_not_in_two_runs_hold_nothing(names):
    assert cs.ops_between_marks(_events(names)) is None


def _held(monkeypatch, profiles):
    seq = iter(profiles)
    taken = []

    def fake(fn, warm):
        assert warm
        taken.append(1)
        return next(seq)

    monkeypatch.setattr(cs, "op_profile", fake)
    found, got, bad = cs.held_op_launches({"bwd_x": lambda: None}, WANT)
    return found, got, bad, len(taken)


def test_a_profile_without_marks_is_taken_again(monkeypatch):
    whole = _counted(_call())
    found, got, bad, n = _held(monkeypatch, [None, whole])
    assert (found, bad, n) == ({"bwd_x": whole}, {}, 2)
    assert got["bwd_x"] == [None, whole]


def test_a_short_profile_is_taken_again(monkeypatch):
    whole = _counted(_call())
    short = _counted(_call()[3:])
    found, _, bad, n = _held(monkeypatch, [short, whole])
    assert (found, bad, n) == ({"bwd_x": whole}, {}, 2)


@pytest.mark.parametrize("extra", [RED, "void other_kernel(float*)"],
                         ids=["second_reduce", "foreign_op"])
def test_an_op_too_many_fails_at_once(monkeypatch, extra):
    ops = _counted(_call() + [extra])
    found, _, bad, n = _held(monkeypatch, [ops, _counted(_call())])
    assert (found, bad, n) == ({}, {"bwd_x": ops}, 1)


def test_no_profile_holding_every_op_fails(monkeypatch):
    attempts = cs.TRAINBN_OP_ATTEMPTS
    short = _counted(_call()[1:])
    profiles = [None, short] * attempts
    found, got, bad, n = _held(monkeypatch, profiles)
    assert found == {} and n == attempts
    assert bad == {"bwd_x": profiles[:attempts]}


BG_BWD = ["void (anonymous namespace)::ball_group_bwd_kernel<1, 8>((ano",
          "Memset (Device)"]
BG_WANT = {"backward": {"ball_group_bwd_kernel": 1, "emset": 2}}


def test_the_ball_groups_short_profile_is_taken_again(monkeypatch):
    # a profile that lost the first of the backward's two memsets is taken
    # again, and the next one, holding both, is the call's
    whole = _counted(["Memset (Device)"] + BG_BWD)
    seq = iter([_counted(BG_BWD), whole])
    monkeypatch.setattr(cs, "op_profile", lambda fn, warm: next(seq))
    found, got, bad = cs.held_op_launches({"backward": lambda: None}, BG_WANT)
    assert (found, bad) == ({"backward": whole}, {})
    assert len(got["backward"]) == 2


MAX_BWD = "void (anonymous namespace)::ball_group_max_bwd_kernel<__nv_b"


@pytest.mark.parametrize("memsets,held", [(0, True), (1, True), (2, False)],
                         ids=["no_memset", "one_memset", "two_memsets"])
def test_an_op_a_call_may_add_is_held_up_to_its_count(monkeypatch, memsets,
                                                      held):
    ops = _counted(["Memset (Device)"] * memsets + [MAX_BWD])
    seq = iter([ops])
    monkeypatch.setattr(cs, "op_profile", lambda fn, warm: next(seq))
    found, _, bad = cs.held_op_launches(
        {"backward": lambda: None},
        {"backward": {"ball_group_max_bwd_kernel<": 1}},
        {"backward": {"emset": 1}})
    assert (found, bad) == (({"backward": ops}, {}) if held
                            else ({}, {"backward": ops}))
