"""``launch.layers.device_ms`` on the CPU, with the profiler's kernel rows
stubbed: a window that lost every kernel record is taken again, the median
window is the result, and a profiler that never sees device time raises."""
import pytest
import torch

from repro_torch.launch import layers


def _stub_rows(monkeypatch, windows):
    """Each profiled window returns the next of ``windows`` as its rows."""
    it = iter(windows)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(layers, "device_kernels", lambda prof: next(it))


def test_device_ms_takes_an_empty_window_again(monkeypatch):
    # 20 calls a window, two kernels a call: 0.1 + 0.05 ms, then 0.3 + 0.05
    # ms, then 0.2 + 0.05 ms; the middle of the three is 0.25
    windows = [[], [("a", 2.0, 20), ("b", 1.0, 20)], [],
               [("a", 6.0, 20), ("b", 1.0, 20)],
               [("a", 4.0, 20), ("b", 1.0, 20)]]
    _stub_rows(monkeypatch, windows)
    calls = []
    got = layers.device_ms(lambda: calls.append(1), calls=20, rounds=3)
    assert got == pytest.approx(0.25)
    assert len(calls) == 1 + 5 * 20


@pytest.mark.parametrize("empty_windows", [1, 5])
def test_device_ms_raises_when_no_window_sees_the_device(monkeypatch,
                                                         empty_windows):
    _stub_rows(monkeypatch, [[]] * empty_windows)
    with pytest.raises(AssertionError, match="no device time"):
        layers.device_ms(lambda: None, calls=2, rounds=3,
                         empty_windows=empty_windows)
