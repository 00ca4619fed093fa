"""Training substrate: AdamW (``optimizer``), train and eval steps
(``steps``) and the host-side data streams (``data``)."""
