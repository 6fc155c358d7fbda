"""decode_enqueue_ms.serve: the mean host time of the program's span
``serve.decode`` (``launch.serve.serve``: one decode step and its argmax
enqueued), in ms, over the traced batch's decode steps after its first.
The first (``serve.first_decode``) is left out: its launches wait on the
card's full queue behind the prefill's, which is the prefill's time.
With ``decode_wait_ms.serve`` it makes up the step ``decode_step_ms.serve``
times from outside.  None where the program records no such span."""
from bench.program_records import mean_host_ms


def read(obs: dict) -> float | None:
    return mean_host_ms("serve.decode")
