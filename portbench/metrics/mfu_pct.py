"""The whole training step's share of the H100's float32 peak (67 TFLOP/s;
the port keeps TF32 off): the operations of the traced run's window
iterations, counted from the configuration's shapes (the networks' matrix
products, ``counts.networks``, and the sweep, ``counts.sweep``, once per
rollout step), over their host-clock seconds. Physics work outside the
sweep and all elementwise work are not counted, so the share is a floor."""

from ..counts import networks, sweep

LAYER = "training step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "env_steps_per_s"


def read(run):
    times = run.iteration_s
    if not times:
        return None
    n = run.traffic["num_envs"]
    nets = networks.iteration_flops(run.config, run.obs_size, run.act_size, n)
    per_it = (nets["rollout"] + nets["update"]
              + run.config["agent_parameters"]["horizon"] * sweep.flops(run.config["sweep"], n))
    return per_it * len(times) / sum(times) / sweep.H100_FP32_FLOPS * 100
