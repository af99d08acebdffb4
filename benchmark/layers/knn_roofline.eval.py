"""The k-NN kernel's share of its roofline, in evaluation cells
(``readings.knn_roofline``)."""

from benchmark.readings import knn_roofline as read  # noqa: F401
