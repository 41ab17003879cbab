"""The consumer of the spawned round trip in ``test_torch_incubate_rest``:
it imports the port only (a spawned process imports this module by name).
"""


def echo(q_in, q_out, device):
    """Take one Tensor from ``q_in`` (rebuilt on ``device``), send it back
    on ``q_out``, wait for the producer's acknowledgement (this process's
    exit would unlink the segment it sent), then report the names of the
    segments it made."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.incubate.multiprocessing as pmp

    paddle.set_device(device)
    pmp.init_reductions()
    t = q_in.get(timeout=120)
    q_out.put((str(t.value.device), t))
    q_in.get(timeout=120)
    q_out.put([s.name for s in pmp._LIVE_SEGMENTS])
