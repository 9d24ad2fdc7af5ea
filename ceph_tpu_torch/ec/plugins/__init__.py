"""Built-in erasure-code plugin modules.

Each module is the analogue of a ``libec_<name>.so`` and is loaded by
``ErasureCodePluginRegistry.load`` via importlib (the dlopen analogue);
it must expose ``__erasure_code_version__`` and
``__erasure_code_init__(name, registry)``.
"""
