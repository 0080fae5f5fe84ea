"""The reading of a device trace: busy time as the union of device
operations, idle stretches named by what the tracing thread's host was
running, device time by kernel name."""

from bench.harness import trace


class Ev:
    def __init__(self, name, kind, start, dur, tid=1):
        self._n, self._k, self._s, self._d, self._t = (name, kind, start,
                                                        dur, tid)

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._k}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._t


def test_busy_idle_and_names():
    events = [
        Ev(trace.MARK, "CPU", 0, 1),
        Ev("aten::mm", "CPU", 100, 50),
        Ev("aten::copy_", "CPU", 400, 300),        # host busy over a gap
        Ev("feed::parse", "CPU", 0, 10_000, tid=2),  # another thread
        Ev("flash_wgmma_kernel", "CUDA", 100, 200),
        Ev("gemm", "CUDA", 250, 100),              # overlaps the first
        Ev("gemm", "CUDA", 600, 100),
        Ev("flash_wgmma_kernel", "CUDA", 1000, 100),
    ]
    s = trace.summarise(events, 2e-6)
    assert abs(s.busy_s - (250 + 100 + 100) * 1e-9) < 1e-15
    assert abs(s.device_s("flash_") - 300e-9) < 1e-15
    assert abs(s.by_name["gemm"] - 200e-9) < 1e-15
    # gaps 350-600 (mid 475: copy_ runs) and 700-1000 (mid 850: none)
    assert abs(s.idle_by_host["aten::copy_"] - 250e-9) < 1e-15
    assert abs(s.idle_by_host["python"] - 300e-9) < 1e-15
    b = s.breakdown()
    assert b["device_ops"][0][0] == "flash_wgmma_kernel"
    assert len(b["idle_gaps"]) == 2


def test_step_means_leave_out_the_steps_that_start_and_stop_the_trace():
    from bench.harness.readings import step_mean_ms
    run = {"step_times": [{"data_wait_s": w}
                          for w in (0.01, 1.5, 0.01, 2.5, 0.01)],
           "tracer_steps": [1, 3]}
    assert abs(step_mean_ms(run, "data_wait_s") - 10.0) < 1e-9
    assert abs(step_mean_ms(dict(run, tracer_steps=[]), "data_wait_s")
               - 806.0) < 1e-9
