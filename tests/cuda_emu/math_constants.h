// CPU stand-in for math_constants.h.
#pragma once
#include <cmath>
#define CUDART_INF_F INFINITY
