"""lmms-eval model plugin of the port: the counterpart of ``scripts/lmms_unigen_tpu.py``.

lmms-eval loads a model class from its own ``lmms_eval/models`` package, so
this module is meant to be loaded as a plugin (placed or linked there, as
``scripts/setup_eval.sh`` does for the JAX one); it imports lmms-eval at its
top and nothing else of the port imports it. Then::

    python -m lmms_eval --model unigen_tpu_torch \\
        --model_args config=configs/unigen_1_5b/unigen_sft.yaml,batch_size=8 --tasks pope

The class only adapts lmms-eval's ``Instance`` requests; the model is
``evaluation.lmms_adapter.UniGenLmmsAdapter`` over
``launch.build_pipeline(initialize_config(config))`` on the card (``device``
names another).
"""
from typing import List, Optional, Tuple

from lmms_eval.api.instance import Instance
from lmms_eval.api.model import lmms
from lmms_eval.api.registry import register_model


@register_model("unigen_tpu_torch")
class UniGenTpuTorch(lmms):
    def __init__(
        self,
        config: str,
        pretrained: Optional[str] = None,
        batch_size: int = 1,
        mm_input_mode: str = "first",
        max_new_tokens: int = 512,
        serving: bool = False,
        serving_slots: int = 16,
        serving_speculate_k: int = 0,
        device: Optional[str] = None,
        **kwargs,
    ) -> None:
        super().__init__()
        from unigen_tpu_torch import launch
        from unigen_tpu_torch.evaluation.lmms_adapter import UniGenLmmsAdapter
        from unigen_tpu_torch.utils.configuration import initialize_config

        overrides = [f"model.unigen.pretrained_model_path={pretrained}"] if pretrained else []
        pipeline = launch.build_pipeline(initialize_config(config, overrides), device=device)
        self.adapter = UniGenLmmsAdapter(
            pipeline, multi_image_mode="concat" if mm_input_mode == "concat" else "first",
            max_new_tokens=int(max_new_tokens), batch_size=int(batch_size),
            serving=str(serving).lower() in ("1", "true"), serving_slots=int(serving_slots),
            serving_speculate_k=int(serving_speculate_k))
        self.batch_size_per_gpu = int(batch_size)

    def generate_until(self, requests: List[Instance]) -> List[str]:
        packed = []
        for req in requests:
            contexts, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
            packed.append((contexts, gen_kwargs,
                           doc_to_visual(self.task_dict[task][split][doc_id])))
        return self.adapter.generate_until(packed)

    def loglikelihood(self, requests: List[Instance]) -> List[Tuple[float, bool]]:
        packed = []
        for req in requests:
            contexts, doc_to_target, doc_to_visual, doc_id, task, split = req.args
            doc = self.task_dict[task][split][doc_id]
            continuation = doc_to_target(doc) if callable(doc_to_target) else doc_to_target
            packed.append((contexts, continuation, doc_to_visual(doc)))
        return self.adapter.loglikelihood(packed)

    def generate_until_multi_round(self, requests) -> List[str]:
        raise NotImplementedError("multi-round dialogue is not supported")
