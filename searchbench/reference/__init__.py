"""The plain reference of the search sidecar's answers: a naive storage
read and encoded (``encode.py``), a table scored (``score.py``) and a
campaign's search state worked out again request by request
(``campaign.py``), with NumPy alone. It imports nothing of the programs
it judges."""
