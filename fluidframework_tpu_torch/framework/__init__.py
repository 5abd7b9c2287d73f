"""The framework layer over the runtime and the DDSes.

Counterpart of ``fluidframework_tpu/framework/``: the declarative container
(``fluid_static``), the service client (``client``), data objects and the
runtime factory (``data_object``), undo-redo, attribution, op
interception, the agent scheduler, dependency synthesis and the small
helper packages (``helpers``). The entry points that build device-backed
channels take ``device=``.
"""
