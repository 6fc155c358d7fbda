"""decode_wait_ms.serve: the mean host time of the program's span
``serve.readback`` (``launch.serve.serve``: the step's token read back,
so the host's wait for the card), in ms, over the traced batch's steps.
None where the program records no such span."""
from bench.program_records import mean_host_ms


def read(obs: dict) -> float | None:
    return mean_host_ms("serve.readback")
