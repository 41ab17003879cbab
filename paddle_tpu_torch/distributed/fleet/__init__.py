"""``paddle_tpu.distributed.fleet`` counterparts: only ``utils`` (the
filesystem clients) is ported; the fleet's meshes and collectives are
ROADMAP module item 11."""
from . import utils  # noqa: F401
