"""ComfyUI package registration of the port's node (counterpart of the root
comfyui_init.py).

Inside ComfyUI/custom_nodes, a package whose __init__.py is this file's
content registers the port's `Eden_LoRa_trainer` node (node.py).
"""

from sd_lora_trainer_tpu_torch.node import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
