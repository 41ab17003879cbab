"""HybridParallelInferenceHelper: generative inference over a static KV
cache, at one rank.

The port of ``paddle_tpu/distributed/fleet/utils/hybrid_parallel_inference.py``.
A generation is one prefill and a per-token step over fixed ``[B, prompt +
new]`` K/V buffers written in place (the model's static cache ``(k_buf,
v_buf, length)``):

* the prefill builds the buffers with the Python-int length 0, so the
  prompt runs the causal flash kernel; the head reads the last position
  only;
* the per-token step feeds the cache a 0-d device tensor length: its write
  lands at ``length`` through one fixed-shape index write and its read is
  the whole buffer under the causal-plus-validity mask, so nothing is read
  on the host.  On the card the step (forward, head, argmax, the length's
  increment and the next input's write) is captured once as a CUDA graph
  per ``(batch, prompt, total length, dtype)`` key, under the serving
  engine's process-wide capture lock, and replayed; on the CPU the same
  function runs eagerly.  The retrace sentinel books one build per key
  (``hybrid_parallel_inference.step``), as it books the train step's;
* greedy decoding without an EOS replays the graph back to back with the
  argmax inside it (JAX's single ``lax.scan``): no host sync between
  tokens, and the tokens cross to the host once at the end;
* sampled and EOS generations step token by token on the host, as JAX's
  do, with :meth:`HybridParallelInferenceHelper._sample` (numpy, the JAX
  helper's arithmetic and ``RandomState`` draws).

The tensor-parallel and pipeline ranks of the reference helper are not
ported here (ROADMAP module entry 11).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....observability.retrace import instrument_jit

__all__ = ["HybridParallelInferenceHelper"]

# the retrace sentinel's name for the per-token step's builds
STEP_NAME = "hybrid_parallel_inference.step"


class _Decoder:
    """The buffers and the captured step of one ``(batch, prompt, total
    length, dtype)`` key."""

    def __init__(self, model, batch, prompt, total, dtype):
        dev = next(torch.nn.Module.parameters(model)).device
        cfg = model.gpt.config
        H = cfg.num_attention_heads
        D = cfg.hidden_size // H
        self.model = model
        self.prompt = prompt
        self.device = dev
        on_card = dev.type == "cuda"
        self.caches = [(torch.zeros((batch, total, H, D), dtype=dtype,
                                    device=dev),
                        torch.zeros((batch, total, H, D), dtype=dtype,
                                    device=dev))
                       for _ in range(cfg.num_layers)]
        self.length = torch.zeros((), dtype=torch.int32, device=dev)
        self.ids = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.prompt_ids = torch.zeros((batch, prompt), dtype=torch.int64,
                                      device=dev)
        self.seq = torch.zeros((batch, total), dtype=torch.int64, device=dev)
        self.rows = torch.arange(batch, device=dev)
        # pinned host staging for the prompt, the sampled ids and the
        # tokens' one copy back
        self.prompt_host = torch.zeros((batch, prompt), dtype=torch.int64,
                                       pin_memory=on_card)
        self.ids_host = torch.zeros((batch, 1), dtype=torch.int64,
                                    pin_memory=on_card)
        self.seq_host = torch.zeros((batch, total), dtype=torch.int64,
                                    pin_memory=on_card)
        self.graph = None
        self.logits = None
        if on_card:
            self._capture()

    def _forward_last(self, ids, caches):
        """``_cached_forward`` of the JAX helper: the trunk over ``caches``
        and the head at the last position only."""
        x, _ = self.model.gpt(ids, caches=caches, use_cache=True)
        return self.model.lm_head(x[:, -1:])[:, 0]

    def step(self):
        """One token: the forward at ``length`` over the buffers, then the
        argmax becomes the next input and is written at ``length + 1`` of
        the token buffer.  What the graph captures."""
        caches = [(k, v, self.length) for k, v in self.caches]
        logits = self._forward_last(self.ids, caches)
        nxt = logits.argmax(dim=-1)
        self.length.add_(1)
        self.ids.copy_(nxt[:, None])
        self.seq.index_put_((self.rows, self.length.long().expand_as(nxt)),
                            nxt)
        return logits

    def _capture(self):
        from ....serving.engine import _capture_lock

        with _capture_lock:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.logits = self.step()
        self.graph = graph

    def _upload(self, dst, host, arr):
        host.numpy()[...] = arr
        dst.copy_(host, non_blocking=True)

    def prefill(self, ids):
        """The prompt through the static prefill (the Python-int length 0:
        the flash kernel); leaves its argmax as the next input at
        ``length = prompt``.  Returns the last position's logits."""
        self._upload(self.prompt_ids, self.prompt_host, ids)
        caches = [(k, v, 0) for k, v in self.caches]
        logits = self._forward_last(self.prompt_ids, caches)
        nxt = logits.argmax(dim=-1)
        self.length.fill_(self.prompt)
        self.ids.copy_(nxt[:, None])
        self.seq[:, self.prompt] = nxt
        return logits

    def advance(self):
        """One step: a replay on the card, the eager step on the CPU."""
        if self.graph is not None:
            self.graph.replay()
            return self.logits
        return self.step()

    def feed(self, nxt):
        """Make ``nxt`` (host ids ``[B]``) the next step's input."""
        self._upload(self.ids, self.ids_host, nxt[:, None])

    def tokens(self, n):
        """The ``n`` generated tokens, copied to the host once."""
        out = self.seq_host[:, self.prompt:self.prompt + n]
        out.copy_(self.seq[:, self.prompt:self.prompt + n],
                  non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return out.numpy().copy()


class HybridParallelInferenceHelper:
    """Drive a cached GPT (``model.gpt`` + ``model.lm_head``, as the port's
    ``GPTForPretraining``) as an autoregressive generator.

    Args:
        model: the model, on its device.
        max_length: the default number of new tokens (the reference
            helper's ``max_len``).
    """

    def __init__(self, model, max_length: int = 128):
        self.model = model
        self.max_length = max_length
        self._decoders: dict = {}
        self._make = instrument_jit(self._new_decoder, STEP_NAME)

    def _new_decoder(self, batch, prompt, total, dtype):
        return _Decoder(self.model, batch, prompt, total, dtype)

    def _decoder(self, batch, prompt, total):
        dtype = self.model.gpt.embeddings.word_embeddings.weight.dtype
        key = (batch, prompt, total, dtype)
        dec = self._decoders.get(key)
        if dec is None:
            dec = self._decoders[key] = self._make(batch, prompt, total,
                                                   dtype)
        return dec

    @staticmethod
    def _sample(logits, temperature, top_k, rng):
        """The JAX helper's host sampler: argmax at temperature 0, else a
        temperature (and top-k) softmax draw per row with ``rng``."""
        if torch.is_tensor(logits):
            logits = logits.detach().float().cpu().numpy()
        logits = np.asarray(logits, np.float32)
        if temperature == 0.0:
            return logits.argmax(axis=-1)
        logits = logits / max(temperature, 1e-6)
        if top_k:
            kth = np.partition(logits, -top_k, axis=-1)[:, [-top_k]]
            logits = np.where(logits < kth, -1e30, logits)
        logits = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=-1, keepdims=True)
        return np.array([rng.choice(len(row), p=row) for row in p])

    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0) -> np.ndarray:
        """Autoregressive generation; returns ``[batch, prompt + new]``
        ids (fewer columns when every row stopped at ``eos_token_id``)."""
        was_training = self.model.training
        self.model.eval()
        try:
            ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                             else input_ids).astype(np.int64)
            n_new = (self.max_length if max_new_tokens is None
                     else int(max_new_tokens))
            rng = np.random.RandomState(seed)
            if n_new < 1:
                return ids
            with torch.no_grad():
                # buffers sized to this call's total length: each distinct
                # (batch, prompt, new) pair costs one capture of the step
                dec = self._decoder(ids.shape[0], ids.shape[1],
                                    ids.shape[1] + n_new)
                last = dec.prefill(ids)
                if temperature == 0.0 and eos_token_id is None:
                    # greedy, no early exit: the steps back to back on the
                    # device, the tokens copied once
                    for _ in range(n_new - 1):
                        dec.advance()
                    return np.concatenate([ids, dec.tokens(n_new)], axis=1)
                out = [ids]
                alive = np.ones(ids.shape[0], bool)
                for pos in range(n_new):
                    nxt = self._sample(last, temperature, top_k, rng)
                    if eos_token_id is not None:
                        nxt = np.where(alive, nxt, eos_token_id)
                        alive &= nxt != eos_token_id
                    out.append(nxt[:, None].astype(np.int64))
                    if (eos_token_id is not None and not alive.any()) or \
                            pos == n_new - 1:
                        break
                    dec.feed(nxt)
                    last = dec.advance()
            return np.concatenate(out, axis=1)
        finally:
            if was_training:
                self.model.train()
