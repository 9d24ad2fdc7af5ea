"""OSD-side erasure-code glue (``ecutil``: stripe math, batched
encode/decode, HashInfo)."""
