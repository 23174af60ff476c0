"""The optimizer of the port's train step: AdamW (:mod:`.adamw`) and int8
gradient compression with error feedback (:mod:`.compress`)."""
