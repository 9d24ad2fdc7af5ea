"""CRUSH: the map model (``types``), its construction (``builder``), the
scalar rule interpreter (``mapper``, the oracle), the batched mapper on
the card (``cudamapper``) and ``crushtool --test`` (``tester``)."""
