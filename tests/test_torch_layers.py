"""``launch.layers.device_ms`` and ``profile_window`` on the CPU, with the
card stubbed.  ``device_ms`` reads CUDA events around calls queued behind
a spin kernel: a window in which the host fell behind the card (its start
event reached before every call was queued) is taken again with a longer
spin, the median window is the result, and a host that never gets ahead
raises.  ``profile_window`` takes a window that lost a marker kernel
again after a longer pause, and leaves the markers out of its rows."""
import pytest
import torch

from repro_torch.launch import layers


def _stub_events(monkeypatch, windows):
    """Each ``device_ms`` window reads the next of ``windows``: (whether
    the host got ahead of the card, the events' elapsed ms).  Returns the
    spins launched."""
    it = iter(windows)
    spins = []

    class Event:
        def __init__(self, enable_timing=False):
            self.window = (False, 0.0)

        def record(self):
            pass

        def query(self):
            self.window = next(it)
            return not self.window[0]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return self.window[1]

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setitem(layers.DEVICE_WINDOWS, "spin_cycles",
                        layers.SPIN_CYCLES)
    return spins


def test_device_ms_takes_an_empty_window_again(monkeypatch):
    # windows the host fell behind in are taken again; 20 calls a window
    # read 0.15, 0.35 and 0.25 ms a call; the middle of the three is 0.25
    windows = [(False, 1.0), (True, 3.0), (False, 1.0), (True, 7.0),
               (True, 5.0)]
    _stub_events(monkeypatch, windows)
    calls = []
    got = layers.device_ms(lambda: calls.append(1), calls=20, rounds=3)
    assert got == pytest.approx(0.25)
    assert len(calls) == 1 + 5 * 20


@pytest.mark.parametrize("late_windows", [1, 5])
def test_device_ms_raises_when_no_window_sees_the_device(monkeypatch,
                                                         late_windows):
    _stub_events(monkeypatch, [(False, 1.0)] * late_windows)
    with pytest.raises(AssertionError, match="no device time"):
        layers.device_ms(lambda: None, calls=2, rounds=3,
                         late_windows=late_windows)


def test_device_ms_pauses_longer_after_each_empty_window(monkeypatch):
    """Each window the host fell behind in doubles the spin that holds
    the stream while the host queues a window's calls, from
    ``SPIN_CYCLES``; later windows, in later calls too, keep it."""
    ahead = (True, 1.0)
    spins = _stub_events(monkeypatch, [(False, 1.0), (False, 1.0)]
                         + [ahead] * 6)
    layers.device_ms(lambda: None, calls=20, rounds=3)
    step = layers.SPIN_CYCLES
    assert spins == [step, 2 * step, 4 * step, 4 * step, 4 * step]
    layers.device_ms(lambda: None, calls=20, rounds=3)
    assert spins[5:] == [4 * step] * 3
    assert layers.DEVICE_WINDOWS["spin_cycles"] == 4 * step


def _stub_profiles(monkeypatch, windows):
    """Each profiled window reads the next of ``windows``: (the markers
    it lost, its kernel rows).  Returns the host pauses and the marker
    spins."""
    it = iter(windows)
    pauses, spins, rows = [], [], []
    monkeypatch.setitem(layers.PROFILER_WINDOWS, "pause_s",
                        layers.PROFILE_PAUSE_S)
    monkeypatch.setitem(layers.PROFILER_WINDOWS, "lost", [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(layers.time, "sleep", pauses.append)

    def lost_markers(prof):
        lost, window_rows = next(it)
        rows[:] = window_rows
        return lost

    monkeypatch.setattr(layers, "lost_markers", lost_markers)
    monkeypatch.setattr(layers, "device_kernels", lambda prof: list(rows))
    return pauses, spins


MARKER_ROW = ("void at::cuda::(anonymous namespace)::spin_kernel(long)",
              0.001, 2)


def test_profile_window_leaves_its_markers_out(monkeypatch):
    rows = [("gemm", 2.0, 4), MARKER_ROW, ("softmax", 0.5, 4)]
    pauses, spins = _stub_profiles(monkeypatch, [("", rows)])
    calls = []
    got, wall_ms = layers.profile_window(lambda: calls.append(1), "work")
    assert got == [("gemm", 2.0, 4), ("softmax", 0.5, 4)]
    assert wall_ms >= 0 and calls == [1]
    p = layers.PROFILE_PAUSE_S
    assert pauses == [p] and spins == [1, 1]


@pytest.mark.parametrize("lost", ["first", "last", "both"])
def test_profile_window_takes_a_window_that_lost_a_marker_again(
        monkeypatch, lost):
    """A window that lost a marker lost records: it is taken again after
    a pause twice as long, which later windows keep, and noted."""
    rows = [("gemm", 2.0, 4), MARKER_ROW]
    pauses, _ = _stub_profiles(monkeypatch, [(lost, rows[:1]), ("", rows),
                                             ("", rows)])
    got, _ = layers.profile_window(lambda: None, "work")
    assert got == [("gemm", 2.0, 4)]
    layers.profile_window(lambda: None, "work")
    p = layers.PROFILE_PAUSE_S
    assert pauses == [p, 2 * p, 2 * p]
    (note,) = layers.PROFILER_WINDOWS["lost"]
    assert (note["label"], note["marker"], note["pause_s"]) == \
        ("work", lost, p)


def test_profile_window_raises_after_its_tries(monkeypatch):
    _stub_profiles(monkeypatch, [("first", [("gemm", 1.0, 3)])] * 3)
    with pytest.raises(AssertionError, match="lost records of work"):
        layers.profile_window(lambda: None, "work", tries=3)


class _Prof:
    """Kernel events as ``prof.events()`` gives them, with a CPU op."""

    def __init__(self, names):
        from types import SimpleNamespace as NS
        cuda, cpu = (torch.autograd.DeviceType.CUDA,
                     torch.autograd.DeviceType.CPU)
        self._events = [NS(name="aten::mm", device_type=cpu,
                           time_range=NS(start=-1.0))] + [
            NS(name=n, device_type=cuda, time_range=NS(start=float(t)))
            for t, n in reversed(list(enumerate(names)))]

    def events(self):
        return self._events


@pytest.mark.parametrize("names, lost", [
    (["spin_kernel", "gemm", "softmax", "spin_kernel"], ""),
    (["gemm", "softmax", "spin_kernel"], "first"),
    (["spin_kernel", "gemm", "softmax"], "last"),
    (["gemm", "softmax"], "both"),
    (["spin_kernel"], "last"),
    (["spin_kernel", "spin_kernel"], ""),
])
def test_lost_markers_reads_the_first_and_last_kernels(names, lost):
    assert layers.lost_markers(_Prof(names)) == lost
