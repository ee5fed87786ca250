"""Traffic kinds: one driver module per `kind` that a traffic mix names.

A driver gives `setup(ctx)` (the program under test, its inputs and its
warm-up; returns the state the rest takes), `window(ctx, state, seconds,
span)` (the timed traffic; returns a `Window`), `stretch(ctx, state, span)`
(the mix's `trace_calls` calls or steps under the profiler),
`expected_launches(ctx, state, attempted)` (the port's launch counts that a
window of `attempted` calls or steps must show), `release(state)` (frees the
program's state) and `numbers(ctx, state, precision)` (the numbers that
decide `correct`; with `precision` other than "fp32" the reference in that
precision stands in for the program, the control)."""

from dataclasses import dataclass, field


@dataclass
class Window:
    attempted: int                 # requests or steps in the window, each waited for
    frames: int                    # their video frames
    seconds: float                 # from the first call to the last completion
    host_call_s: list = field(default_factory=list)   # host time inside each call
    latencies_s: list = field(default_factory=list)   # serve: submission to outputs on the host
    failed: int = 0                # steps whose loss is not finite
