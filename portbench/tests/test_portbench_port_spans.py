"""``trace.reduce`` beside the port's own spans (``any4.*``,
``any4_tpu_torch/tracing.py``).

- On a synthetic trace its window, busy time, kernels, idle time and
  breakdown are frozen here as literals of ``trace.py`` as it was before
  the port had spans.
- The port's spans are operator events on the host with no copy on the
  device, so adding them to that trace changes none of those readings.
"""
from types import SimpleNamespace as NS

from torch.autograd import DeviceType

from portbench import trace


def ev(name, s, e, dev=False):
    return NS(name=name, time_range=NS(start=s, end=e),
              device_type=DeviceType.CUDA if dev else DeviceType.CPU)


# the harness's spans and the device's work, in microseconds
BASE = [ev("portbench.admit", 1000.0, 1850.5),
        ev("portbench.client", 1850.5, 1862.25),
        ev("portbench.decode", 1870.0, 2410.75),
        ev("portbench.client", 2410.75, 2415.0),
        ev("portbench.decode", 2420.5, 2950.125),
        ev("aten::mm", 1005.0, 1010.0),
        ev("kernel_a", 1100.25, 1300.5, True),
        ev("kernel_a", 1290.0, 1400.0, True),
        ev("softmax", 1500.0, 1530.75, True),
        ev("decode_kernel", 1900.0, 2000.0, True),
        ev("kernel_a", 2100.5, 2200.0, True),
        ev("portbench.decode", 1900.0, 2200.0, True),
        ev("kernel_a", 2500.0, 2700.25, True),
        ev("copy", 2940.0, 3100.0, True),
        ev("copy", 900.0, 1001.0, True)]

# trace.reduce and trace.breakdown of BASE, before the port had spans
FROZEN = (0.0019501249999999998, 0.000741375,
          {"kernel_a": 0.00061, "softmax": 3.0749999999999995e-05,
           "decode_kernel": 9.999999999999999e-05, "copy": 0.000261},
          {"portbench.admit": 0.0005189999999999999,
           "portbench.client": 1.6e-05, "portbench.decode": 0.0006605,
           "host.outside_spans": 1.325e-05})
FROZEN_BREAKDOWN = {
    "device_ops": [["kernel_a", 0.00061], ["copy", 0.000261],
                   ["decode_kernel", 9.999999999999999e-05],
                   ["softmax", 3.0749999999999995e-05]],
    "idle_gaps": [["portbench.decode", 0.0006605],
                  ["portbench.admit", 0.0005189999999999999],
                  ["portbench.client", 1.6e-05],
                  ["host.outside_spans", 1.325e-05]]}

# the port's spans inside BASE's admission and first decode, nested as
# the engine opens them, on the host only
PORT = [ev("any4.engine.admit", 1001.0, 1849.0),
        ev("any4.engine.prefill", 1010.0, 1700.0),
        ev("any4.model.attn", 1050.0, 1450.0),
        ev("any4.linear", 1090.0, 1095.0),
        ev("any4.attn.prefill", 1401.0, 1449.0),
        ev("any4.engine.read", 1700.0, 1845.0),
        ev("any4.engine.schedule", 1871.0, 1880.0),
        ev("any4.engine.decode", 1880.0, 2300.0),
        ev("any4.model.attn", 1880.0, 2050.0),
        ev("any4.kv.write", 1885.0, 1890.0),
        ev("any4.linear", 1890.0, 1899.0),
        ev("any4.model.ffn", 2050.0, 2290.0),
        ev("any4.linear", 2060.0, 2100.0),
        ev("any4.engine.read", 2300.0, 2400.0),
        ev("any4.engine.absorb", 2400.0, 2410.0)]


def _reading(events):
    t = trace.reduce(events)
    return (t.window_s, t.busy_s, t.kernels, t.idle), trace.breakdown(t)


def test_reduce_is_frozen():
    assert _reading(BASE) == (FROZEN, FROZEN_BREAKDOWN)


def test_port_spans_leave_the_reading_unchanged():
    assert _reading(BASE + PORT) == (FROZEN, FROZEN_BREAKDOWN)
    assert _reading(PORT + BASE[::-1]) == (FROZEN, FROZEN_BREAKDOWN)
