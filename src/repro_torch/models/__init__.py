"""The port's language models: config-driven blocks (``layers``,
``attention``), the decoder stack (``lm``) and the weight carrier from
the reference package (``convert``)."""
