"""The fleet's metric names, shared by the gateway's router and (once it
is ported, ROADMAP section 1, module entry 9) the autoscaler.

The JAX package defines them in ``paddle_tpu/serving/autoscaler.py``; the
port keeps the same names here, so a dashboard reads either package."""

__all__ = ["FLEET_DESIRED", "FLEET_ALIVE", "FLEET_DRAINING",
           "FLEET_SCALE_EVENTS"]

FLEET_DESIRED = "paddle_tpu_fleet_replicas_desired"
FLEET_ALIVE = "paddle_tpu_fleet_replicas_alive"
FLEET_DRAINING = "paddle_tpu_fleet_replicas_draining"
FLEET_SCALE_EVENTS = "paddle_tpu_fleet_scale_events_total"
