"""prefill_ms.serve: the mean host-clock time of one ``Model.prefill``
call of the window, the card synchronised before and after it (traced
runs only)."""


def read(obs: dict) -> float | None:
    return obs.get("prefill_ms")
