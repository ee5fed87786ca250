"""What the metric readers of `metrics/` share. A reader is `read(run)`
-> a number, or None where its run holds nothing to read (no profiled
stretch, or none of the kernels it names ran there)."""

import statistics

from benchmark import bounds, stats


def frames_per_s(run):
    return run.window.frames / run.window.seconds


def host_ms_per_call(run):
    return 1e3 * statistics.fmean(run.window.host_call_s)


def mfu(run, passes):
    """The share of the fp32 peak that the configuration's forward FLOPs a
    frame, times `passes` (1 serving; 3 training: forward and two for the
    backward), over the frames and seconds of the window make."""
    flops = run.ctx.adapter.flops_per_frame(run.ctx.config) * passes * run.window.frames
    return 100 * flops / run.window.seconds / bounds.PEAK_FLOPS


def device_idle(run):
    if run.trace is None or run.trace.busy_s == 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)


def roofline(run, least_s_per_call, *kernels, gemms=False):
    """The least time of the stretch's calls over the device time of the
    named kernels, with every GEMM's where `gemms`, in percent; None where
    none of the named kernels ran."""
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(*kernels)
    if seconds == 0:
        return None
    if gemms:
        seconds += run.trace.gemm_seconds()
    return 100 * least_s_per_call * run.trace.calls / seconds


def p95_ms(run):
    return 1e3 * stats.percentile(run.window.latencies_s, 95)


def k1_roofline(run):
    """K1's least time for the whole OPNet forward (`bounds.opnet_fused`,
    the input projection `scene @ W1_ih` in it) over the device time of
    what computes it: `opnet_fused_kernel` and the GEMM in which the wrapper
    runs that projection before the launch (the served stretch runs no
    other GEMM)."""
    c, mix = run.ctx.config, run.ctx.mix
    least = bounds.least_seconds(*bounds.opnet_fused(
        mix["videos"], mix["frames"], h1=c["object_to_track_hidden_dim"],
        h2=c["videos_hidden_dim"]))
    return roofline(run, least, "opnet_fused_kernel", gemms=True)


def lstm_train_roofline(run):
    """The least time of every LSTM layer's recurrence, forward (K2) and
    backward (K3), over the device time of the kernels that run them: the
    forward, and the backward's tile product, carry loop and split sum."""
    mix = run.ctx.mix
    least = sum(bounds.least_seconds(*bounds.lstm_forward(mix["videos"], mix["frames"], h))
                + bounds.least_seconds(*bounds.lstm_backward(mix["videos"], mix["frames"], h))
                for h in run.ctx.adapter.lstm_widths(run.ctx.config))
    return roofline(run, least, "lstm_fwd_kernel", "tile_product_kernel",
                    "lstm_bwd_loop_kernel", "sum_splits_kernel")


def lstm_serve_roofline(run):
    """The least time of every LSTM layer's forward recurrence emitting h
    alone (K4) over the device time of the forward kernel."""
    mix = run.ctx.mix
    least = sum(bounds.least_seconds(*bounds.lstm_forward(mix["videos"], mix["frames"], h,
                                                          emit_cells=False))
                for h in run.ctx.adapter.lstm_widths(run.ctx.config))
    return roofline(run, least, "lstm_fwd_kernel")


def mfu_serve(run):
    return mfu(run, passes=1)


def mfu_train(run):
    return mfu(run, passes=3)
