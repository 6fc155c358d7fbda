"""optim_ms.train: the mean device time of one ``optimizer.update``, from
CUDA events recorded on the stream before and after each update of the
window (traced runs)."""


def read(obs: dict) -> float | None:
    return obs.get("optim_ms")
