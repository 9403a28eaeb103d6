from monte_carlo_localization_tpu_torch.mapping.edt import (
    clearance_field,
    euclidean_distance_transform,
)
from monte_carlo_localization_tpu_torch.mapping.grid_map import (
    GridMap,
    load_map,
    map_from_occupancy,
    occupancy_from_image,
)
from monte_carlo_localization_tpu_torch.mapping.synthetic import (
    box_world,
    corridor_world,
    random_obstacle_world,
)

__all__ = [
    "GridMap",
    "load_map",
    "map_from_occupancy",
    "occupancy_from_image",
    "clearance_field",
    "euclidean_distance_transform",
    "box_world",
    "corridor_world",
    "random_obstacle_world",
]
