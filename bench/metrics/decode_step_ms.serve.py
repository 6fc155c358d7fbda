"""decode_step_ms.serve: the mean host-clock time from one
``Model.decode_step`` call of a batch to the next (the serving loop reads
each step's token back, so a step ends on the card before the next
starts)."""


def read(obs: dict) -> float | None:
    return obs.get("decode_step_ms")
