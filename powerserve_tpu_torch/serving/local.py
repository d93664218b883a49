"""In-process serving API: the model registry and the continuous-batching
scheduler behind a small synchronous surface, no HTTP — for Python hosts
(notebooks, agent frameworks, test harnesses) that embed the engine:

    from powerserve_tpu_torch.serving.local import LocalServer

    srv = LocalServer("/path/to/models", model="llama8b")  # device cuda
    text = srv.completion("The capital of France is", max_tokens=16)
    for piece in srv.completion("Tell me a story", stream=True):
        print(piece, end="", flush=True)
    reply = srv.chat([{"role": "user", "content": "hi"}])
    reply = srv.chat([{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,..."}},
        {"type": "text", "text": "what is this?"}]}], model="internvl")
    srv.close()

Same semantics as the HTTP server: chat templates, images on a
vision-language model (data: URIs of PNGs or JPEGs, on a workspace or an
HF InternVL checkpoint dir; an HTTPError of status 400
for what the server answers with a 400), UTF-8-safe streaming, stop
strings and ids, per-request sampling. Thread-safe: requests ride the
scheduler's own queue. Images are decoded in worker subprocesses
(serving/image_workers.py) that import nothing of the host's
`__main__`, so a script needs no `if __name__ == "__main__":` guard.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..core.config import HyperParams
from .server import (IncrementalDecoder, ModelContext, ServerContext,
                     StopMatcher, _sampling_from_body, _split_multimodal,
                     generate)

SAMPLING_KEYS = {"max_tokens", "temperature", "top_k", "top_p",
                 "repeat_penalty", "frequency_penalty", "presence_penalty",
                 "seed"}


class LocalServer:
    """Synchronous in-process front end over ServerContext."""

    def __init__(self, model_root, model: str = "",
                 hp: HyperParams | None = None,
                 device: str | torch.device | None = None,
                 tp: int = 1, dp: int = 1, dist_backend: str | None = None,
                 max_models: int = 0, weight_format: str = "gguf"):
        """tp, dp, dist_backend: serve over tp * dp ranks; max_models:
        keep at most that many model contexts loaded; weight_format: gguf
        or w8 (ServerContext)."""
        self.ctx = ServerContext(model_root, model, hp or HyperParams(),
                                 device, tp=tp, dp=dp,
                                 dist_backend=dist_backend,
                                 max_models=max_models,
                                 weight_format=weight_format)
        self.default_model = model

    def _stream(self, mctx: ModelContext, prompt_ids: list[int],
                sampling: dict, stop_strings: list[str],
                embeds: torch.Tensor | None = None) -> Iterator[str]:
        tok = mctx.tokenizer
        stop_ids = set(tok.stop_ids)
        dec = IncrementalDecoder(tok)
        matcher = StopMatcher(stop_strings)
        for t, req in generate(mctx, prompt_ids, sampling, stop_ids, embeds):
            piece = matcher.push(dec.push(t) if t not in stop_ids else "")
            if matcher.stopped:
                req.cancelled = True
            if piece:
                yield piece
            if matcher.stopped:
                return
        # end of stream: the decoder's held-back bytes and the matcher's
        # unmatched tail
        tail = matcher.push(dec.flush())
        if not matcher.stopped:
            tail += matcher.flush()
        if tail:
            yield tail

    @staticmethod
    def _sampling(kw: dict) -> dict:
        """The request body's sampling keys, with the server's defaults."""
        unknown = set(kw) - SAMPLING_KEYS
        if unknown:
            raise TypeError(f"unknown sampling params: {sorted(unknown)}")
        return _sampling_from_body(kw)

    def _serve(self, model: str | None, prompt, sampling: dict,
               stop: list[str]) -> Iterator[str]:
        """The reply's pieces with the model's context in flight (no
        eviction takes it) from the prompt's preparation to the end of the
        stream: prompt(mctx) -> (ids, input rows or None)."""
        with self.ctx.use(model or self.default_model) as (mctx, _):
            ids, embeds = prompt(mctx)
            yield from self._stream(mctx, ids, sampling, stop, embeds)

    def completion(self, prompt: str, model: str | None = None,
                   stream: bool = False, stop: list[str] | None = None,
                   **sampling):
        """Plain completion. stream=False -> str; True -> piece iterator
        (the prompt is prepared at its first piece)."""
        it = self._serve(model, lambda mctx: (mctx.tokenize(prompt), None),
                         self._sampling(sampling), stop or [])
        return it if stream else "".join(it)

    def chat(self, messages: list[dict], model: str | None = None,
             stream: bool = False, stop: list[str] | None = None,
             **sampling):
        """Chat completion through the model's chat template; OpenAI
        content arrays with data: image URIs run the VLM path."""
        text_messages, images = _split_multimodal(messages)

        def prompt(mctx):
            text = mctx.tokenizer.apply_chat_template(text_messages)
            return self.ctx.vlm_prompt(mctx, mctx.tokenize(text), images)

        it = self._serve(model, prompt, self._sampling(sampling), stop or [])
        return it if stream else "".join(it)

    def metrics(self, model: str | None = None) -> dict:
        return self.ctx.get(model or self.default_model).scheduler.metrics()

    def close(self) -> None:
        self.ctx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
