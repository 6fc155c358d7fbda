"""The most device memory the allocator held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in
GiB."""


def read(obs: dict) -> float | None:
    return obs["peak_bytes"] / 2 ** 30 if obs.get("peak_bytes") else None
