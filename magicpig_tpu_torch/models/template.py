"""Chat prompt templates (port of `magicpig_tpu/models/template.py`)."""

Templates = {
    "meta-llama2": "[INST] {} [/INST]",
    "meta-llama3": (
        "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n"
        "{}<|eot_id|>\n<|start_header_id|>assistant<|end_header_id|>\n"
    ),
    "None": "{}",
}
