"""OSD-side glue: erasure-code stripe math, batched encode/decode and
HashInfo (``ecutil``); pools and placement groups (``types``), the
cluster map and its scalar pg -> up/acting pipeline (``osdmap``), the
whole-cluster batched remap (``remap``) and the upmap balancer
(``balancer``)."""
