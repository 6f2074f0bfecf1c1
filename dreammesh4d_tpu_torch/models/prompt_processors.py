"""The ``dummy-prompt-processor`` of the image-conditioned stages
(counterpart of ``dreammesh4d_tpu/models/prompt_processors.py``).  The
text-prompt processor lives in ``models/guidance/stable_diffusion.py``
(``stable-diffusion-prompt-processor``)."""

from __future__ import annotations

from dataclasses import dataclass

from ..registry import register


@dataclass
class PromptProcessorOutput:
    text_embeddings: object = None
    prompt: str = ""


@register("dummy-prompt-processor")
@dataclass
class DummyPromptProcessor:
    pretrained_model_name_or_path: str = ""
    prompt: str = ""

    def __call__(self) -> PromptProcessorOutput:
        return PromptProcessorOutput(prompt=self.prompt)
