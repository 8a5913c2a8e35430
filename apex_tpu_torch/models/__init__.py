from apex_tpu_torch.models.bert import (
    BertConfig,
    BertEmbeddings,
    BertEncoder,
    BertForPreTraining,
    BertHeads,
    BertLayer,
    BertSelfAttention,
    BertStage,
    PipelinedBert,
    bert_base,
    bert_large,
)
from apex_tpu_torch.models.bert import params_from_jax as bert_params_from_jax
from apex_tpu_torch.models.dcgan import (
    Discriminator,
    Generator,
    dcgan_params_from_jax,
)
from apex_tpu_torch.models.gpt import (
    GPTBlock,
    GPTConfig,
    GPTEmbed,
    GPTLMHeadModel,
    GPTSelfAttention,
    GPTStage,
    PipelinedGPT,
    gpt_medium,
    gpt_small,
    lm_loss,
    params_from_jax,
)
from apex_tpu_torch.models.mlp import MLP, mlp_params_from_jax
from apex_tpu_torch.models.moe import EP_RULES, MoEMlp, ep_rules
from apex_tpu_torch.models.moe import params_from_jax as moe_params_from_jax
from apex_tpu_torch.models.pipelined_common import PipelinedCommon
from apex_tpu_torch.models.resnet import (
    BasicBlock,
    BatchNorm,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    default_norm,
    resnet_params_from_jax,
    s2d_input_transform,
    space_to_depth,
    stem_to_s2d,
)

__all__ = ["BasicBlock", "BatchNorm", "BertConfig", "BertEmbeddings",
           "BertEncoder", "BertForPreTraining", "BertHeads", "BertLayer",
           "BertSelfAttention", "BertStage", "Bottleneck", "Discriminator",
           "EP_RULES", "GPTBlock", "GPTConfig", "GPTEmbed", "GPTLMHeadModel",
           "GPTSelfAttention", "GPTStage", "Generator", "MLP", "MoEMlp",
           "PipelinedBert", "PipelinedCommon", "PipelinedGPT", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "bert_base", "bert_large", "bert_params_from_jax",
           "dcgan_params_from_jax", "default_norm", "ep_rules", "gpt_medium",
           "gpt_small", "lm_loss", "mlp_params_from_jax", "moe_params_from_jax",
           "params_from_jax",
           "resnet_params_from_jax", "s2d_input_transform", "space_to_depth",
           "stem_to_s2d"]
